"""launch_ms.bpr: the host's ms in the call of an epoch's program (on a card
the copies of its inputs and its graph's launch): the median of the
program's ``bpr_launch`` host spans
(``qmf_tpu_torch.utils.tracing.host_spans``) in steady untraced calls. A
call is an epoch, the host span ``bpr_epoch_N``; ``tracing.in_calls`` leaves
out the calls a profiler recorded and the program's first two: the eager
warm-up with the capture, and the graph's first launch, many times slower
than the later ones. None where the program records none."""

import statistics

from qmf_tpu_torch.utils import tracing


def read(ctx):
    if not hasattr(tracing, "in_calls"):
        return None
    values = [(s.end_ns - s.start_ns) / 1e6 for s in tracing.in_calls(
        tracing.host_spans("bpr_launch"), "bpr_epoch_", skip=2)]
    return statistics.median(values) if values else None
