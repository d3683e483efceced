"""The port's tracing hooks (qmf_tpu_torch/utils/tracing.py) on the CPU.

``trace`` is qmf_tpu's context manager on torch.profiler: a no-op without
a directory, else a Chrome trace written into the directory named by its
argument or by QMF_TPU_TRACE_DIR. ``annotate`` labels the engines' epochs
(``wals_epoch_{n}``, ``bpr_epoch_{n}``, at qmf_tpu's places), and the
trace holds each label around the epoch's operations; each label is also
kept as a host span. ``part`` stamps a region at entry and exit, on the
host's clock here and on the card's (a kernel, replayed with its graph)
there; the engines' parts nest as the program does, and stamping changes
no number. The test marked ``gpu`` skips without a card and nvcc; it
imports no jax, so on the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_tracing.py
"""

import contextlib
import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from qmf_tpu_torch.config import BPRConfig, WALSConfig
from qmf_tpu_torch.data import Dataset
from qmf_tpu_torch.models import BPREngine, WALSEngine
from qmf_tpu_torch.models.recommend import recommend_top_n
from qmf_tpu_torch.ops.bpr_ops import make_pos_set
from qmf_tpu_torch.utils import StepTimer, annotate, trace, tracing


@pytest.fixture(autouse=True)
def _empty_store():
    tracing.clear()
    yield
    tracing.clear()


def _dataset(seed=0, n_users=30, n_items=20, per_user=6):
    rng = np.random.default_rng(seed)
    users, items = [], []
    for u in range(n_users):
        users += [u + 1] * per_user
        items += list(rng.choice(n_items, size=per_user, replace=False) + 1)
    return Dataset(np.array(users), np.array(items),
                   rng.integers(1, 6, len(users)).astype(np.float64))


def _events(trace_dir):
    files = glob.glob(os.path.join(str(trace_dir), "*.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def _span(events, name):
    hits = [e for e in events if e.get("name") == name and e.get("ph") == "X"]
    assert len(hits) == 1, (name, len(hits))
    return hits[0]["ts"], hits[0]["ts"] + hits[0]["dur"]


def test_trace_without_a_directory_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.delenv("QMF_TPU_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with trace():
        x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0
    assert not torch.autograd.profiler._is_profiler_enabled
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("where", ["argument", "environment"])
def test_trace_around_a_wals_epoch(tmp_path, monkeypatch, where):
    """One CPU WALS epoch under trace(): the written trace holds the
    wals_epoch_1 span, and the solve's operations inside it."""
    eng = WALSEngine(WALSConfig(nepochs=1, nfactors=4, dtype="float64",
                                fuse_epoch=False), device="cpu")
    eng.init(_dataset())
    out = tmp_path / "trace"
    if where == "environment":
        monkeypatch.setenv("QMF_TPU_TRACE_DIR", str(out))
        ctx = trace()
    else:
        monkeypatch.delenv("QMF_TPU_TRACE_DIR", raising=False)
        ctx = trace(str(out))
    with ctx:
        eng.optimize()
    events = _events(out)
    lo, hi = _span(events, "wals_epoch_1")
    inside = {e["name"] for e in events
              if e.get("ph") == "X" and lo <= e["ts"] <= hi}
    assert any("cholesky" in name for name in inside), sorted(inside)
    assert not torch.autograd.profiler._is_profiler_enabled


def test_bpr_epochs_are_annotated(tmp_path):
    eng = BPREngine(BPRConfig(nepochs=2, nfactors=4, batch_size=32,
                              dtype="float64"), device="cpu")
    eng.init(_dataset(seed=1))
    with trace(str(tmp_path)):
        eng.optimize()
    events = _events(tmp_path)
    first, second = _span(events, "bpr_epoch_1"), _span(events, "bpr_epoch_2")
    assert first[1] <= second[0]


def test_annotate_nests_and_is_cheap_untraced(tmp_path):
    with annotate("outside"):  # no profiler: only the label's bookkeeping
        pass
    with trace(str(tmp_path)):
        with annotate("outer"):
            with annotate("inner"):
                torch.ones(4).sum()
    events = _events(tmp_path)
    outer, inner = _span(events, "outer"), _span(events, "inner")
    assert outer[0] <= inner[0] and inner[1] <= outer[1]


def test_step_timer_records_and_summarizes():
    timer = StepTimer()
    for _ in range(3):
        with timer.measure("epoch"):
            pass
    with pytest.raises(RuntimeError):
        with timer.measure("failing"):
            raise RuntimeError("recorded all the same")
    summary = timer.summary()
    assert summary["epoch"][0] == 3 and summary["failing"][0] == 1
    count, total, mean = summary["epoch"]
    assert mean == pytest.approx(total / count)
    timer.log_summary()


def test_host_spans_nest_with_parents_and_profiler_flag(tmp_path):
    with annotate("outer"):
        with annotate("inner"):
            pass
    with trace(str(tmp_path)):
        with annotate("traced"):
            pass
    spans = {s.name: s for s in tracing.host_spans()}
    assert set(spans) == {"outer", "inner", "traced"}
    assert spans["inner"].parent == "outer" and spans["outer"].parent is None
    outer, inner = spans["outer"], spans["inner"]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert not outer.profiled and spans["traced"].profiled
    # the profiler's host clock: time.time_ns
    assert spans["traced"].end_ns <= time.time_ns()
    assert [s.name for s in tracing.host_spans("inner")] == ["inner"]


def test_host_span_store_is_bounded_and_keeps_failures():
    timer = StepTimer(capacity=3)
    for i in range(5):
        with timer.span(f"s{i}"):
            pass
    with pytest.raises(ValueError):
        with timer.span("failing"):
            raise ValueError("recorded all the same")
    assert [s.name for s in timer.spans] == ["s3", "s4", "failing"]
    assert timer.records == {}  # measure()'s records are apart


def test_part_on_the_cpu_stamps_the_host_clock():
    before = time.time_ns()
    with tracing.part("outer_part", "cpu"):
        for _ in range(2):
            with tracing.part("inner_part", "cpu"):
                time.sleep(0.002)
    with pytest.raises(RuntimeError):
        with tracing.part("inner_part", "cpu"):
            raise RuntimeError("no instance")
    after = time.time_ns()
    spans = tracing.device_spans()
    assert [n for n, _, _ in spans] == ["outer_part", "inner_part",
                                        "inner_part"]
    (_, s0, e0), (_, s1, e1), (_, s2, e2) = spans
    assert before <= s0 <= s1 <= e1 <= s2 <= e2 <= e0 <= after
    inner = tracing.span_ms("inner_part")
    assert len(inner) == 2 and min(inner) >= 2.0
    assert tracing.children_ms("outer_part", "inner_part") == \
        pytest.approx([sum(inner)])
    # each part is also a host span, around its stamps
    host = tracing.host_spans("outer_part")
    assert len(host) == 1 and host[0].start_ns <= s0 and e0 <= host[0].end_ns
    assert tracing.children_ms("no_such_part", "inner_part") == []
    tracing.clear()
    assert tracing.device_spans() == [] and tracing.host_spans() == []


def test_parts_pair_by_name_and_survive_a_wrapped_store():
    tracing.clear()
    tag = tracing._part_tag("wrapped")
    stamps = [(tag + 1, 5), (tag, 10), (tag, 20), (tag + 1, 30),
              (tag + 1, 40)]  # an exit whose entry was overwritten first
    assert tracing._paired(stamps, 100) == [("wrapped", 120, 130),
                                            ("wrapped", 110, 140)]


def test_in_calls_keeps_the_steady_untraced_calls(tmp_path):
    """A part's instances are read per call: the first call (the warm-up)
    and the calls a profiler recorded are left out."""
    for i in range(5):
        traced = trace(str(tmp_path)) if i == 2 else contextlib.nullcontext()
        with traced, annotate(f"call_{i}"):
            with tracing.part("work", "cpu"):
                with tracing.part("piece", "cpu"):
                    time.sleep(0.001)
    work = tracing.device_spans("work")
    assert len(work) == 5
    assert tracing.in_calls(work, "call_") == [work[1], work[3], work[4]]
    assert tracing.in_calls(work, "call_", skip=3) == [work[3], work[4]]
    assert tracing.span_ms("work", call="call_") == pytest.approx(
        [(e - s) / 1e6 for _, s, e in (work[1], work[3], work[4])])
    pieces = tracing.children_ms("work", "piece", call="call_")
    assert len(pieces) == 3 and min(pieces) >= 1.0
    host = tracing.in_calls(tracing.host_spans("work"), "call_")
    assert [h.parent for h in host] == ["call_1", "call_3", "call_4"]
    assert tracing.in_calls(work, "no_such_call") == []


def test_part_without_the_kernel_library_is_its_host_span(monkeypatch):
    """On a CUDA device whose kernel library does not load, a part warns
    once and is its host span alone: no stamp, nothing raised."""
    from qmf_tpu_torch import kernels

    def no_library():
        raise RuntimeError("no nvcc")

    warnings = []
    monkeypatch.setattr(kernels, "load", no_library)
    monkeypatch.setattr(tracing, "_launchers", {})
    monkeypatch.setattr(tracing, "_stampers", {})
    monkeypatch.setattr(tracing.log, "warning",
                        lambda *a: warnings.append(a))
    for _ in range(2):
        with tracing.part("unstamped", "cuda:3"):
            with tracing.part("unstamped_inner", "cuda:3"):
                pass
    assert len(warnings) == 1
    assert [s.name for s in tracing.host_spans()] == [
        "unstamped_inner", "unstamped"] * 2
    assert tracing.device_spans() == []


def _train_set(seed=0, n_users=40, n_items=30, per_user=8):
    return _dataset(seed, n_users, n_items, per_user)


def _wals(fuse_epoch, class_solve=True):
    eng = WALSEngine(WALSConfig(nepochs=2, nfactors=4, dtype="float64",
                                fuse_epoch=fuse_epoch,
                                class_solve=class_solve), device="cpu")
    eng.init(_train_set())
    eng.optimize()
    return eng


def _inside(parent, child):
    """Each instance of child lies inside one instance of parent."""
    outer = tracing.device_spans(parent)
    for _, s, e in tracing.device_spans(child):
        assert any(ps <= s and e <= pe for _, ps, pe in outer), child


@pytest.mark.parametrize("fuse_epoch,class_solve",
                         [(True, True), (False, True), (False, False)])
def test_wals_records_its_parts(fuse_epoch, class_solve):
    _wals(fuse_epoch, class_solve)
    assert len(tracing.span_ms("wals_epoch")) == 2
    for child in ("wals_build", "wals_solve"):
        assert tracing.device_spans(child)
        _inside("wals_epoch", child)
        per_epoch = tracing.children_ms("wals_epoch", child)
        assert len(per_epoch) == 2 and min(per_epoch) > 0
    build = tracing.children_ms("wals_epoch", "wals_build")
    solve = tracing.children_ms("wals_epoch", "wals_solve")
    for b, s, e in zip(build, solve, tracing.span_ms("wals_epoch")):
        assert b + s <= e
    assert {s.parent for s in tracing.host_spans("wals_build")} == {
        "wals_epoch"}


def _bpr(grouped=True):
    eng = BPREngine(BPRConfig(nepochs=2, nfactors=4, batch_size=32,
                              dtype="float64", grouped_epoch=grouped),
                    device="cpu")
    eng.init(_train_set(seed=1))
    eng.optimize()
    return eng


def test_bpr_records_its_parts_and_host_spans():
    _bpr()
    assert len(tracing.span_ms("bpr_epoch")) == 2
    for child in ("bpr_pass1", "bpr_sgd"):
        _inside("bpr_epoch", child)
        assert len(tracing.children_ms("bpr_epoch", child)) == 2
    assert len(tracing.span_ms("bpr_eval")) == 2
    launch, wait = (tracing.host_spans(n) for n in ("bpr_launch", "bpr_wait"))
    assert len(launch) == len(wait) == 2
    assert {s.parent for s in launch} == {"bpr_epoch_1", "bpr_epoch_2"}
    assert not any(s.profiled for s in launch)
    # on the CPU the launch is the eager epoch, which it encloses
    for (_, s, e), h in zip(tracing.device_spans("bpr_epoch"), launch):
        assert h.start_ns <= s and e <= h.end_ns


def test_serving_records_its_parts():
    users, items = (np.arange(1, 41).repeat(6),
                    np.tile(np.arange(1, 7), 40) * 3)
    seen = make_pos_set(users - 1, items - 1, 40, device="cpu")
    g = torch.Generator().manual_seed(0)
    uf, itf = torch.randn(40, 4, generator=g), torch.randn(30, 4, generator=g)
    for _ in range(3):
        recommend_top_n(uf, itf, np.arange(16), n=5, seen=seen, device="cpu")
    assert len(tracing.span_ms("serve_request")) == 3
    for child in ("serve_scores", "serve_seen", "serve_topn"):
        _inside("serve_request", child)
    parts = [tracing.children_ms("serve_request", c)
             for c in ("serve_scores", "serve_seen", "serve_topn")]
    for request, *each in zip(tracing.span_ms("serve_request"), *parts):
        assert 0 < sum(each) <= request


@contextlib.contextmanager
def _noop_part(name, device):
    yield


def test_stamps_change_no_number(monkeypatch):
    """Factors, BPR parameters and served answers are the same bit for bit
    with part() a no-op."""
    def run():
        wals = [_wals(True), _wals(False, class_solve=False)]
        bpr = _bpr()
        seen = make_pos_set(np.arange(40).repeat(3),
                            np.tile(np.arange(3), 40) * 7, 40, device="cpu")
        g = torch.Generator().manual_seed(3)
        uf, itf = torch.randn(40, 6, generator=g), torch.randn(30, 6,
                                                                 generator=g)
        served = recommend_top_n(uf, itf, np.arange(40), n=4, seen=seen,
                                 device="cpu")
        return ([t for e in wals for t in (e.user_factors, e.item_factors)]
                + list(bpr.params), served)

    stamped, served = run()
    assert tracing.device_spans()
    tracing.clear()
    monkeypatch.setattr(tracing, "part", _noop_part)
    plain, plain_served = run()
    assert tracing.device_spans() == []
    assert all(torch.equal(a, b) for a, b in zip(stamped, plain))
    assert all(np.array_equal(a, b) for a, b in zip(served, plain_served))


@pytest.mark.gpu
def test_replayed_graph_stamps_every_replay_on_the_card():
    """On a card: a captured WALS epoch's parts are stamped at every
    replay, children inside their epoch, and the ``wals_epoch`` span of a
    replay agrees with CUDA events around it within 5%."""
    from qmf_tpu_torch import kernels
    from qmf_tpu_torch.ops import graphs

    if not kernels.available():
        pytest.skip("needs a CUDA device and nvcc "
                    "(kernels.available() is False)")
    dev = torch.device("cuda")
    eng = WALSEngine(WALSConfig(nepochs=1, nfactors=64, dtype="float32",
                                fuse_epoch=True), device=dev)
    eng.init(_dataset(seed=2, n_users=20000, n_items=4000, per_user=60))
    eng.optimize()  # the warm-up and the capture
    program = eng._epoch_program()
    assert isinstance(program, graphs.EpochGraph)
    tracing.clear()
    v = eng.item_factors.clone()
    events = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        # the card waits here while the host launches the graph, so the
        # events time the replay's run and not its launch
        torch.cuda._sleep(100_000_000)
        start.record()
        program(v)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    epoch = tracing.span_ms("wals_epoch")
    assert len(epoch) == 5
    for child in ("wals_build", "wals_solve"):
        _inside("wals_epoch", child)
        assert len(tracing.children_ms("wals_epoch", child)) == 5
    for span, (start, end) in zip(epoch, events):
        assert span == pytest.approx(start.elapsed_time(end), rel=0.05)
    assert tracing.host_spans() == []  # a replay passes no host code


@pytest.mark.gpu
def test_part_spans_line_up_with_the_profiler_on_the_card():
    """On a card, under torch.profiler: each ``serve_seen`` device span
    starts after its host span opens, and within 1 ms of the first kernel
    the profiler saw start after that opening."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qmf_tpu_torch import kernels

    if not kernels.available():
        pytest.skip("needs a CUDA device and nvcc "
                    "(kernels.available() is False)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    n_users, n_items = 4000, 3000
    users = np.arange(n_users).repeat(20)
    items = rng.integers(0, n_items, users.shape[0])
    seen = make_pos_set(users, items, n_users, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    uf = torch.randn(n_users, 32, generator=g, device=dev)
    itf = torch.randn(n_items, 32, generator=g, device=dev)
    recommend_top_n(uf, itf, np.arange(1024), n=10, seen=seen, device=dev)
    torch.cuda.synchronize()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            recommend_top_n(uf, itf, np.arange(1024), n=10, seen=seen,
                            device=dev)
        torch.cuda.synchronize()
    base = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    starts = sorted(
        base + int(e.time_range.start * 1000) for e in events
        if e.device_type == DeviceType.CUDA and e.name not in host_names
        and "stamp" not in e.name and "memcpy" not in e.name.lower()
        and "memset" not in e.name.lower())
    host, device = (tracing.host_spans("serve_seen"),
                    tracing.device_spans("serve_seen"))
    assert len(host) == len(device) == 3
    for h, (_, s, _) in zip(host, device):
        assert h.profiled and h.start_ns <= s
        first = starts[bisect.bisect_left(starts, h.start_ns)]
        assert abs(first - s) < 1_000_000, (first - s)
