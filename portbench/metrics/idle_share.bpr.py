"""idle_share.bpr: the share of the traced window (the calls after a
lead-in) in which no operation ran on the device, in %
(``portbench/shares.py``)."""

from portbench.shares import idle_share as read  # noqa: F401
