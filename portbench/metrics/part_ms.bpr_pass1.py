"""part_ms.bpr_pass1: an epoch's pass 1: the shuffle and the negatives'
sampler, in ms: the median, over the program's ``bpr_epoch`` spans in steady
untraced calls, of the summed ``bpr_pass1`` spans inside each. The spans are
parts of ``qmf_tpu_torch.utils.tracing``, stamped on the card's clock (also
inside a replayed CUDA graph) and on the host's clock on a CPU. A call is an
epoch, the host span ``bpr_epoch_N``; ``tracing.in_calls`` leaves out the
program's first two calls (its warm-up: the eager run and, on a card, the
capture; then the graph's first replay, slower on the card) and the calls a
profiler recorded, so the number reads epochs as an untraced run runs them.
None where the program records no ``bpr_pass1`` span."""

import statistics

from qmf_tpu_torch.utils import tracing


def read(ctx):
    if not hasattr(tracing, "in_calls"):
        return None
    values = tracing.children_ms("bpr_epoch", "bpr_pass1",
                                 call="bpr_epoch_", skip=2)
    return statistics.median(values) if any(values) else None
