"""fuse_epoch in the port (qmf_tpu's one-program epochs) on the CPU.

WALSConfig.fuse_epoch takes qmf_tpu's routes: the whole run as one program
when no epoch needs the host in between (``_can_fuse_run``), else one
program an epoch, and ``fuse_epoch=False`` dispatches each epoch eagerly.
On a CUDA device the program is a CUDA graph (ops/graphs.py); on the CPU it
is the same ops run eagerly, so here the whole run equals the eager epochs
bit for bit (the tolerance is 0), and in float64 it stays within 1e-9 of
qmf_tpu's ``train_epochs`` scan (solver "lu" there, plain cholesky here:
two solves of the same SPD systems). The dataset is
tests/test_torch_wals.py's ``_dataset``. The graph itself runs only on a
card (tests/test_torch_kernels.py); its bookkeeping of the launch counters
is held here against a stand-in for the CUDA graph.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from qmf_tpu.config import MetricsConfig as JaxMetricsConfig
from qmf_tpu.config import WALSConfig as JaxWALSConfig
from qmf_tpu.data.dataset import Dataset as JaxDataset
from qmf_tpu.metrics import MetricsEngine as JaxMetricsEngine
from qmf_tpu.models.wals import WALSEngine as JaxWALSEngine
from qmf_tpu_torch.config import MetricsConfig, WALSConfig
from qmf_tpu_torch.data import Dataset
from qmf_tpu_torch.metrics import MetricsEngine
from qmf_tpu_torch.models import WALSEngine
from qmf_tpu_torch import kernels
from qmf_tpu_torch.ops import als_ops, build_solve, gather, graphs, spd_solve
from qmf_tpu_torch.parallel import Mesh, launch
from qmf_tpu_torch.parallel.dryrun import (read_result, run_jobs,
                                           write_ratings_npz)
from qmf_tpu_torch.utils.logging import log
from qmf_tpu_torch.utils.tracing import trace

torch.set_num_threads(1)

NEPOCHS, K = 3, 16
CFG = dict(nepochs=NEPOCHS, nfactors=K, batch_rows=64, dtype="float64")
F64 = dict(rtol=1e-9, atol=1e-9)


def _dataset(seed=0, n_u=200, n_i=120, nnz=3000):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n_u * n_i, nnz))
    return Dataset(key // n_i + 1, key % n_i + 1,
                   rng.integers(1, 11, len(key)) * 0.5)


def _record_run(eng) -> list:
    """The per-epoch losses of ``eng``'s runs: its progress_cb for
    per-epoch forms, its _fused_run's return for a whole run (whose
    progress_cb is called once)."""
    losses, whole = [], []
    run = eng._fused_run

    def fused_run(nepochs):
        out = run(nepochs)
        losses.extend(out)
        whole.append(True)
        return out

    def progress(epoch, loss, dt):
        if not whole:
            losses.append(loss)
        whole.clear()

    eng._fused_run = fused_run
    eng.progress_cb = progress
    return losses


def _port(ds, ckpt=None, **kw):
    eng = WALSEngine(WALSConfig(**{**CFG, **kw}), device="cpu")
    losses = _record_run(eng)
    if ckpt:
        eng.enable_checkpointing(str(ckpt))
    eng.init(ds)
    eng.optimize()
    return eng, losses


@pytest.mark.parametrize("hot_width", [0, 6])
@pytest.mark.parametrize("solver", ["cholesky", "lu"])
def test_whole_run_equals_eager_epochs(solver, hot_width):
    """(a) fuse_epoch=True (a whole run: als_ops.train_epochs) against
    fuse_epoch=False on the CPU: factors and per-epoch losses bit for
    bit."""
    ds = _dataset()
    fused, f_losses = _port(ds, solver=solver, hot_width=hot_width)
    eager, e_losses = _port(ds, solver=solver, hot_width=hot_width,
                            fuse_epoch=False)
    assert fused._program is not None and eager._program is None
    assert len(f_losses) == NEPOCHS and f_losses == e_losses
    assert torch.equal(fused.user_factors, eager.user_factors)
    assert torch.equal(fused.item_factors, eager.item_factors)


@pytest.mark.parametrize("form", ["whole_run", "per_epoch"])
def test_fuse_epoch_matches_qmf_tpu(form, tmp_path):
    """(b) The port with fuse_epoch=True against qmf_tpu with
    fuse_epoch=True (its train_epochs scan for a whole run, its
    _fused_epoch once an epoch with checkpointing on), float64: factors
    and per-epoch losses within 1e-9."""
    ds = _dataset()
    ckpt = form == "per_epoch"
    jax = JaxWALSEngine(JaxWALSConfig(**CFG, solver="lu", fuse_epoch=True))
    j_losses = _record_run(jax)
    if ckpt:
        jax.enable_checkpointing(str(tmp_path / "jax"))
    jax.init(JaxDataset(ds.user_ids, ds.item_ids, ds.values))
    assert jax._can_fuse_run() == (not ckpt)
    jax.optimize()
    eng, losses = _port(ds, ckpt=tmp_path / "port" if ckpt else None)
    assert eng._can_fuse_run() == (not ckpt)
    assert len(losses) == len(j_losses) == NEPOCHS
    np.testing.assert_allclose(losses, j_losses, **F64)
    for got, want in ((eng.user_factors, jax.user_factors),
                      (eng.item_factors, jax.item_factors)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)


@pytest.mark.parametrize("checkpointing", [False, True])
@pytest.mark.parametrize("always_compute", [False, True])
@pytest.mark.parametrize("fuse_epoch", [False, True])
def test_can_fuse_run_decides_as_qmf_tpu(fuse_epoch, always_compute,
                                         checkpointing, tmp_path):
    """(c) _can_fuse_run over fuse_epoch x always-compute metrics x
    checkpointing: the port's answer is qmf_tpu's."""
    answers = []
    for engine_cls, config_cls, metrics_cls, me_cls, kw in (
            (WALSEngine, WALSConfig, MetricsConfig, MetricsEngine,
             {"device": "cpu"}),
            (JaxWALSEngine, JaxWALSConfig, JaxMetricsConfig,
             JaxMetricsEngine, {})):
        me = me_cls(metrics_cls(num_test_users=5,
                                always_compute=always_compute))
        me.add_test_avg_metric("auc")
        eng = engine_cls(config_cls(fuse_epoch=fuse_epoch), me, **kw)
        eng.test_users = np.arange(5)
        if checkpointing:
            eng.enable_checkpointing(str(tmp_path))
        answers.append(bool(eng._can_fuse_run()))
    assert answers[0] == answers[1]
    assert answers[0] == (fuse_epoch and not always_compute
                          and not checkpointing)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_whole_run_logs_every_epoch_and_calls_progress_once():
    """(d) A whole run logs its eager decision, then one "epoch N: train
    loss" line per epoch after the run, and calls progress_cb once, with
    the last epoch and its loss."""
    handler = _Lines()
    level = log.level
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    try:
        eng = WALSEngine(WALSConfig(**CFG), device="cpu")
        calls = []
        eng.progress_cb = lambda *row: calls.append(row)
        eng.init(_dataset())
        eng.optimize()
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    epochs = [ln for ln in handler.lines if ": train loss = " in ln]
    assert [ln.split(":")[0] for ln in epochs] == [
        f"epoch {e}" for e in range(1, NEPOCHS + 1)]
    assert any("eager ops: cpu is not a CUDA device" in ln
               for ln in handler.lines)
    assert len(calls) == 1 and calls[0][0] == NEPOCHS
    assert f"{calls[0][1]:.10g}" in epochs[-1]


def test_whole_run_is_one_trace_span(tmp_path):
    """A whole run under utils.tracing.trace is one wals_run span (qmf_tpu's
    annotate) holding the solves of every epoch."""
    eng = WALSEngine(WALSConfig(**CFG), device="cpu")
    eng.init(_dataset())
    with trace(str(tmp_path)):
        eng.optimize()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "wals_run"
             and e.get("ph") == "X"]
    assert len(spans) == 1
    assert not any(str(e.get("name", "")).startswith("wals_epoch_")
                   for e in events)
    lo, hi = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    solves = [e for e in events if e.get("ph") == "X"
              and "cholesky_solve" in str(e.get("name", ""))]
    assert solves and all(lo <= e["ts"] <= hi for e in solves)


def test_resume_equals_a_straight_run(tmp_path):
    """(e) Two epochs with checkpointing (one program an epoch), then a
    3-epoch engine resumed from that checkpoint: the factors of a straight
    3-epoch whole run, bit for bit; and factors replaced through
    load_factors feed the next epoch program as a resume does."""
    ds = _dataset()
    straight, s_losses = _port(ds)
    _port(ds, ckpt=tmp_path, nepochs=2)
    resumed, r_losses = _port(ds, ckpt=tmp_path)
    assert r_losses == s_losses[2:]
    assert torch.equal(resumed.user_factors, straight.user_factors)
    assert torch.equal(resumed.item_factors, straight.item_factors)

    two, _ = _port(ds, nepochs=2)
    one = WALSEngine(WALSConfig(**{**CFG, "nepochs": 1}), device="cpu")
    one.init(ds)
    one.optimize()  # a program made and run on other factors first
    one.load_factors(two.user_factors, two.item_factors)
    one.optimize()
    assert torch.equal(one.item_factors, straight.item_factors)


# --- two gloo ranks -----------------------------------------------------------

PAR = dict(nepochs=2, nfactors=5, regularization_lambda=0.07,
           confidence_weight=20.0, init_seed=1, batch_rows=16,
           dtype="float64")


def test_gloo_ranks_fuse_epoch_equals_eager(tmp_path, capfd, monkeypatch):
    """(f) Two gloo CPU ranks of ShardedWALSEngine: fuse_epoch=True (a
    whole run, its epoch program eager by the up-front rule, which the
    ranks log) equals fuse_epoch=False bit for bit, with and without the
    hot split."""
    monkeypatch.setenv("QMF_TPU_LOGLEVEL", "INFO")
    rng = np.random.default_rng(0)
    users, items, vals = [], [], []
    for u in range(61):
        for i in rng.choice(37, size=9, replace=False):
            users.append(u + 10)
            items.append(i + 20)
            vals.append(float(rng.integers(1, 6)))
    train = str(tmp_path / "train.npz")
    write_ratings_npz(train, Dataset(np.array(users), np.array(items),
                                     np.array(vals)))
    jobs = [{"engine": "wals", "train": train,
             "out": str(tmp_path / f"h{hot}_f{int(fuse)}"),
             "config": {**PAR, "hot_width": hot, "fuse_epoch": fuse}}
            for hot in (0, 4) for fuse in (True, False)]
    launch.spawn(run_jobs, 2, device="cpu", args=(jobs,), deadline_s=240)
    err = capfd.readouterr().err
    assert "WALS epoch program runs as eager ops" in err
    assert graphs.UNCAPTURED_BACKENDS["gloo"] in err
    for hot in (0, 4):
        fused = read_result(str(tmp_path / f"h{hot}_f1"))
        eager = read_result(str(tmp_path / f"h{hot}_f0"))
        assert graphs.UNCAPTURED_BACKENDS["gloo"] in str(
            fused["eager_reasons"])
        assert len(fused["losses"]) == 1 and len(eager["losses"]) == 2
        assert fused["losses"][-1] == eager["losses"][-1]
        for key in ("user_factors", "item_factors"):
            np.testing.assert_array_equal(fused[key], eager[key])


# --- the graph's bookkeeping ---------------------------------------------------

def test_eager_reasons():
    """The up-front rule: the CPU, gloo, and any solver a capture refuses
    keep an engine's epochs eager; a card over NCCL or with no group does
    not."""
    assert graphs.eager_reasons(torch.device("cpu")) == [
        "cpu is not a CUDA device"]
    assert graphs.eager_reasons(torch.device("cuda"), "gloo") == [
        graphs.UNCAPTURED_BACKENDS["gloo"]]
    for backend in ("none", "nccl"):
        for solver in ("kernel", "fused", None):
            assert graphs.eager_reasons(torch.device("cuda", 0), backend,
                                        solver) == []
    for solver, why in graphs.UNCAPTURED_SOLVERS.items():
        assert graphs.eager_reasons(torch.device("cuda"), "none",
                                    solver) == [f"solver {solver!r}: {why}"]
    # epoch_program: a graph where nothing stands against it, else the body
    def body(x):
        return x

    card = torch.device("cuda", 0)
    prog, reasons = graphs.epoch_program("test", body, card, solver="kernel")
    assert isinstance(prog, graphs.EpochGraph) and reasons == []
    gloo = Mesh(1, 0, card, backend="gloo")
    assert graphs.epoch_program("test", body, card, gloo) == (
        body, [graphs.UNCAPTURED_BACKENDS["gloo"]])


class _StandIn:
    """The parts of torch.cuda an EpochGraph touches, on the CPU: the
    capture runs its body (as a capture records it without launching), and
    replay() calls ``on_replay`` (a test sets it to what the graph would
    compute)."""

    class CUDAGraph:
        def __init__(self, keep_graph=False):
            self.on_replay = None

        def raw_cuda_graph(self):
            return 0  # no graph handle: no node count

        def instantiate(self):
            pass

        def replay(self):
            self.on_replay()

    @staticmethod
    def graph(graph, stream=None, capture_error_mode="global"):
        import contextlib

        return contextlib.nullcontext()

    @staticmethod
    def stream(stream):
        import contextlib

        return contextlib.nullcontext()

    class Stream:
        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass

    @staticmethod
    def current_stream(device=None):
        return _StandIn.Stream()


def test_epoch_graph_keeps_the_counters_true(monkeypatch):
    """An EpochGraph's first call is the warm-up (counted) and the capture
    (not counted: nothing launches); every replay copies its inputs into
    the static buffers and adds what one call counts, the mesh's
    collectives too."""
    for name in ("CUDAGraph", "graph", "stream", "Stream",
                 "current_stream"):
        monkeypatch.setattr(torch.cuda, name, getattr(_StandIn, name))
    monkeypatch.setattr(spd_solve, "launches", 0)
    monkeypatch.setattr(build_solve, "launches_hot", 0)
    monkeypatch.setattr(gather, "launches", {**gather.launches, "tile": 0})
    mesh = Mesh(1, 0, torch.device("cpu"))

    def body(x):  # three kernel launches and one collective a call
        spd_solve.launches += 1
        build_solve.launches_hot += 1
        gather.launches["tile"] += 1
        mesh.counts["calls"] += 1
        mesh.counts["all_gather_bytes"] += 8
        return x * 2, x.sum()

    g = graphs.EpochGraph(body, mesh)
    x0 = torch.arange(4.0)
    with pytest.raises(ValueError, match="on a CUDA device, not cpu"):
        g(x0)
    with monkeypatch.context() as m:  # the capture asks for a card
        m.setattr(torch.Tensor, "device", property(
            lambda self: torch.device("cuda", 0)))
        warm = g(x0)
    assert torch.equal(warm[0], x0 * 2)
    assert spd_solve.launches == 1 and mesh.counts["calls"] == 1
    assert mesh.counts["all_gather_bytes"] == 8
    assert g.capture_s is not None and g.replays == 0
    static_out = g._outputs
    g._graph.on_replay = lambda: (static_out[0].copy_(g.inputs[0] * 2),
                                  static_out[1].copy_(g.inputs[0].sum()))
    x1 = torch.tensor([1.0, -1.0, 5.0, 0.5])
    out = g(x1)
    assert out is static_out and torch.equal(out[0], x1 * 2)
    assert g.inputs[0] is not x1 and torch.equal(g.inputs[0], x1)
    out = g(out[0])  # an output fed back
    assert torch.equal(out[0], x1 * 4)
    assert g.replays == 2
    assert spd_solve.launches == 3 and mesh.counts["calls"] == 3
    assert build_solve.launches_hot == 3 and gather.launches["tile"] == 3
    assert mesh.counts["all_gather_bytes"] == 24
    with pytest.raises(ValueError, match="captured with"):
        g(torch.zeros(5))


def test_every_wrapper_counter_is_registered():
    """Each kernel wrapper's launch counter is in kernels' registry, which
    an EpochGraph reads and sets: a kernel's counter left out of it would
    tick at the warm-up alone and fall behind at every replay."""
    names = kernels.counter_names()
    assert len(names) == len(set(names))
    assert set(names) == {
        "spd_solve.launches", "spd_solve.launches_t", "build_solve.launches",
        "build_solve.launches_hot",
        *(f"gather.launches[{k}]" for k in gather.launches)}
    before = kernels.read_counters()
    try:
        kernels.write_counters([7] * len(names))
        assert spd_solve.launches == build_solve.launches_hot == 7
        assert set(gather.launches.values()) == {7}
    finally:
        kernels.write_counters(before)
    assert kernels.read_counters() == before
    with pytest.raises(ValueError):
        kernels.write_counters(before[:-1])


def test_train_epochs_stacks_the_losses_on_the_device():
    """als_ops.train_epochs is the loop of train_epoch: the same factors
    and losses, bit for bit, with the losses left in one tensor."""
    ds = _dataset(seed=3, n_u=60, n_i=40, nnz=600)
    eng = WALSEngine(WALSConfig(**CFG), device="cpu")
    eng.init(ds)
    cfg = eng.config
    args = (eng._user_classes, eng._item_classes, cfg.confidence_weight,
            cfg.regularization_lambda, "cholesky", "highest", eng.nusers,
            eng.nitems, eng._user_chunks, eng._item_chunks)
    u, v, losses = als_ops.train_epochs(als_ops.epoch_body(*args),
                                        eng.item_factors, NEPOCHS)
    assert losses.shape == (NEPOCHS,) and losses.dtype == torch.float64
    want_v, want = eng.item_factors, []
    for _ in range(NEPOCHS):
        want_u, want_v, _, loss = als_ops.train_epoch(None, want_v, *args)
        want.append(loss)
    assert torch.equal(losses, torch.stack(want))
    assert torch.equal(u, want_u) and torch.equal(v, want_v)
    with pytest.raises(ValueError, match="nepochs >= 1"):
        als_ops.train_epochs(als_ops.epoch_body(*args), eng.item_factors, 0)
