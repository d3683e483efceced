"""The traced window's arithmetic: busy time as a union, idle stretches."""

from portbench import trace


def test_union_counts_overlap_once():
    merged = trace.union([(10, 20), (15, 25), (30, 31), (0, 1)])
    assert merged == [[0, 1], [10, 25], [30, 31]]
    assert sum(e - s for s, e in merged) == 17


def test_idle_stretches_include_the_edges():
    merged = [[10, 20], [25, 30], [40, 41]]
    assert trace.idle_stretches(merged, 5, 50) == [
        (10, 30, 40), (9, 41, 50), (5, 20, 25), (5, 5, 10)]
    assert trace.idle_stretches([[0, 10]], 0, 10) == []


def test_gap_named_by_innermost_span_and_host_op():
    spans = [(0, 100, "portbench.call"), (10, 90, "wals_run")]
    ops = [(20, 30, "cudaGraphLaunch"), (40, 45, "aten::item")]
    assert trace._innermost(spans, 50) == "wals_run"
    assert trace._host_op(ops, 25) == "cudaGraphLaunch"
    assert trace._host_op(ops, 60) == "after aten::item"
    assert trace._host_op(ops, 5) == "no host op"


def test_serving_parts_are_spans():
    """The program's ``serve_*`` parts name serving's gaps, as the WALS and
    BPR spans do theirs; aten operations and CUDA calls stay host ops."""
    for name in ("portbench.call", "wals_run", "bpr_epoch_3",
                 "serve_request", "serve_scores", "serve_seen", "serve_topn"):
        assert trace.is_span(name), name
    for name in ("aten::topk", "cudaMemcpyAsync", "aten::nonzero"):
        assert not trace.is_span(name), name
    spans = [(0, 100, "portbench.call"), (5, 95, "serve_request"),
             (60, 90, "serve_topn")]
    assert trace._innermost(spans, 70) == "serve_topn"
    assert trace._innermost(spans, 30) == "serve_request"
