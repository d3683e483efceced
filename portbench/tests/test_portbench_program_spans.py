"""The per-layer metrics that read the program's own spans
(``qmf_tpu_torch.utils.tracing``): on each cell's CPU run each reads a
positive number; with the store empty, or from a program that records no
such span (its ``tracing`` without the readers' functions), each reads
None, so the line leaves it out."""

import time

import pytest

from portbench import harness, spec

from test_portbench_drivers import SEED

SPAN_METRICS = {
    "wals_ml20m_k64.train": ["part_ms.wals_build", "part_ms.wals_solve"],
    "bpr_ml20m_k30.train": ["part_ms.bpr_pass1", "part_ms.bpr_sgd",
                            "part_ms.bpr_eval", "launch_ms.bpr"],
    "wals_ml20m_k64.serve": ["part_ms.serve_scores", "part_ms.serve_seen",
                             "part_ms.serve_topn"],
}
ALL = [m for names in SPAN_METRICS.values() for m in names]


@pytest.fixture
def tracing():
    from qmf_tpu_torch.utils import tracing

    tracing.clear()
    yield tracing
    tracing.clear()


def test_every_span_metric_is_declared_for_its_cell():
    bench = spec.load_benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]
                if m["source"] == "program_span"}
    assert set(declared) == set(ALL)
    for cell, names in SPAN_METRICS.items():
        for name in names:
            assert declared[name]["workloads"] == [cell]


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_readers_read_the_programs_spans(tiny_root, tracing, cell):
    c = spec.resolve(cell, root=tiny_root)
    r = harness.run_cell(c, SEED, 0.5, False, "cpu", time.perf_counter(),
                         root=tiny_root)
    assert r.correct, r.checks
    for name in SPAN_METRICS[cell]:
        value = spec.metric_reader(name, tiny_root)(None)
        assert value is not None and value > 0, name


@pytest.mark.parametrize("name", ALL)
def test_reader_of_an_empty_store_reads_none(tracing, name):
    assert spec.metric_reader(name)(None) is None


@pytest.mark.parametrize("name", ALL)
def test_reader_of_a_program_without_parts_reads_none(tracing, monkeypatch,
                                                      name):
    with tracing.part("serve_request", "cpu"):
        with tracing.part("serve_seen", "cpu"):
            pass
    for fn in ("children_ms", "span_ms", "host_spans", "in_calls"):
        monkeypatch.delattr(tracing, fn)
    assert spec.metric_reader(name)(None) is None
