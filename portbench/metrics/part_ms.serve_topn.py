"""part_ms.serve_topn: a request's head: topk, the tie repair and the sort, in
ms: the median, over the program's ``serve_request`` spans in steady
untraced calls, of the summed ``serve_topn`` spans inside each. The spans
are parts of ``qmf_tpu_torch.utils.tracing``, stamped on the card's clock
(also inside a replayed CUDA graph) and on the host's clock on a CPU. A call
is a request, the part's own host span ``serve_request``;
``tracing.in_calls`` leaves out the program's first call (the warm-up
request) and the calls a profiler recorded, so the number reads requests as
an untraced run runs them. None where the program records no ``serve_topn``
span."""

import statistics

from qmf_tpu_torch.utils import tracing


def read(ctx):
    if not hasattr(tracing, "in_calls"):
        return None
    values = tracing.children_ms("serve_request", "serve_topn",
                                 call="serve_request")
    return statistics.median(values) if any(values) else None
