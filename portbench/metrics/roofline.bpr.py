"""roofline.bpr: the least time of the traced calls' work over their device
time, in % (``portbench/shares.py``)."""

from portbench.shares import roofline as read  # noqa: F401
