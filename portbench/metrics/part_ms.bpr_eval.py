"""part_ms.bpr_eval: an epoch's eval loss over its fixed triplets, in ms: the
median of the program's ``bpr_eval`` spans in steady untraced calls (a part
of ``qmf_tpu_torch.utils.tracing``, stamped on the card's clock, and on the
host's clock on a CPU). A call is an epoch, the host span ``bpr_epoch_N``,
which the eval follows; ``tracing.in_calls`` leaves out the program's first
two calls (its warm-up, then the graph's first replay) and the calls a
profiler recorded. None where the program records none."""

import statistics

from qmf_tpu_torch.utils import tracing


def read(ctx):
    if not hasattr(tracing, "in_calls"):
        return None
    values = tracing.span_ms("bpr_eval", call="bpr_epoch_", skip=2)
    return statistics.median(values) if values else None
