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
