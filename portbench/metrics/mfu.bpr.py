"""mfu.bpr: the least time of the work of the calls that a traced run times
before its profiler starts, over their wall on the host's clock, in %: the
whole step's share of the chip's peak (``portbench/shares.py``)."""

from portbench.shares import mfu as read  # noqa: F401
