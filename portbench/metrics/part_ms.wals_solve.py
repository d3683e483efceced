"""part_ms.wals_solve: an epoch's solves: each width class's batched solve and
its loss, in ms: the median, over the program's ``wals_epoch`` spans in
steady untraced calls, of the summed ``wals_solve`` spans inside each. The
spans are parts of ``qmf_tpu_torch.utils.tracing``, stamped on the card's
clock (also inside a replayed CUDA graph) and on the host's clock on a CPU.
A call is an ``optimize()`` call, the host span ``wals_run``;
``tracing.in_calls`` leaves out the program's first two calls (its warm-up:
the eager run and, on a card, the capture; then the graph's first replay,
slower on the card) and the calls a profiler recorded, so the number reads
epochs as an untraced run runs them. None where the program records no
``wals_solve`` span."""

import statistics

from qmf_tpu_torch.utils import tracing


def read(ctx):
    if not hasattr(tracing, "in_calls"):
        return None
    values = tracing.children_ms("wals_epoch", "wals_solve",
                                 call="wals_run", skip=2)
    return statistics.median(values) if any(values) else None
