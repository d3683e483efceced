"""hot_width="auto" in the port: ops/hot.py's rule and its resolution for
each side (qmf_tpu_torch/models/wals.py), against qmf_tpu's.

With qmf_tpu's constants passed in, the port's rule picks what
qmf_tpu.ops.hot.auto_hot_width picks, on seeded Zipf and flat degrees and
for both store widths. The engine resolves "auto" to 0 on the CPU and in
float64, and on float32 on a CUDA device through the rule with its H100
constants. With each side's width forced, float64
engines agree with qmf_tpu's to 1e-9, on one device and on two gloo CPU
ranks. tools/hot_micro.py's fit recovers the constants of points its model
made, and refuses to run without a card. The rule's widths on a card are
held by tests/test_torch_kernels.py ``test_auto_hot_widths_on_the_card``.
"""

import numpy as np
import pytest
import torch

from qmf_tpu.config import WALSConfig as JaxWALSConfig
from qmf_tpu.data.dataset import Dataset as JaxDataset
from qmf_tpu.models.wals import WALSEngine as JaxWALSEngine
from qmf_tpu.ops import hot as jax_hot
from qmf_tpu_torch.config import WALSConfig
from qmf_tpu_torch.data import Dataset
from qmf_tpu_torch.models import WALSEngine
from qmf_tpu_torch.ops import hot
from qmf_tpu_torch.parallel import launch
from qmf_tpu_torch.parallel.dryrun import (
    read_result,
    run_jobs,
    write_ratings_npz,
)
from qmf_tpu_torch.tools import hot_micro

torch.set_num_threads(1)

F64 = dict(rtol=1e-9, atol=1e-12)
TPU = dict(gather_ns_per_row=jax_hot._GATHER_NS_PER_ROW,
           gemm_flops=jax_hot._GEMM_FLOPS)
# one progress_cb a epoch, as qmf_tpu's fuse_epoch=False runs
ENGINE = dict(nepochs=3, nfactors=8, confidence_weight=4.0,
              init_distribution_bound=0.1, init_seed=7, batch_rows=32,
              dtype="float64", fuse_epoch=False)


def _zipf_degrees(seed, n_cols, nnz, a):
    """Column degrees of ``nnz`` draws from a Zipf(a) popularity."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, n_cols + 1, dtype=np.float64) ** -a
    return np.bincount(rng.choice(n_cols, size=nnz, p=p / p.sum()),
                       minlength=n_cols)


def _zipf_dataset(seed=3, n_users=60, n_items=40, nnz=600):
    """Power-law item popularity, n_users != n_items (tests/test_hot.py's
    generator, duplicates removed by np.unique)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_items + 1)
    key = np.unique(rng.integers(0, n_users, nnz) * n_items
                    + rng.choice(n_items, size=nnz, p=p / p.sum()))
    vals = rng.uniform(0.5, 5.0, size=len(key)).round(1)
    return Dataset(key // n_items + 1, key % n_items + 1, vals)


@pytest.mark.parametrize("store_bytes", [2, 4])
@pytest.mark.parametrize("rows,k", [(138_493, 64), (26_744, 64),
                                    (900_000, 30), (3_000, 8)])
@pytest.mark.parametrize("degrees", ["zipf1.1", "zipf0.7", "flat"])
def test_rule_with_tpu_constants_matches_qmf_tpu(degrees, rows, k,
                                                 store_bytes):
    if degrees == "flat":
        deg = np.random.default_rng(5).integers(600, 700, 26_744)
    else:
        deg = _zipf_degrees(k, 26_744, 2_000_000, float(degrees[4:]))
    got = hot.auto_hot_width(deg, rows, k, store_bytes=store_bytes, **TPU)
    assert got == jax_hot.auto_hot_width(deg, rows, k,
                                         store_bytes=store_bytes)


def test_rule_is_the_least_modeled_time():
    """With its default (H100) constants the pick is the candidate of
    least ``modeled_ms`` (the cost the engine logs), among 0 and the widths
    the budget leaves, for both store widths."""
    deg = _zipf_degrees(1, 26_744, 18_000_000, 1.1)
    picks = set()
    for k in (30, 64):
        for rows in (26_744, 138_493, 600_000, 2_000_000):
            for store in (2, 4):
                widths = hot_micro.candidates(deg, rows, store)
                ms = {h: hot.modeled_ms(deg, rows, k, h) for h in widths}
                pick = hot.auto_hot_width(deg, rows, k, store_bytes=store)
                assert pick == min(ms, key=ms.get)
                picks.add(pick)
    assert len(picks) > 2


@pytest.mark.parametrize("dtype,device", [
    ("float32", "cpu"), ("float64", "cpu"), ("float64", "cuda"),
])
def test_auto_resolves_zero_off_float32_cuda(dtype, device):
    """qmf_tpu's gate: "auto" is 0 unless float32 on an accelerator. An
    engine on the CPU resolves 0 on both sides at init; one that would run
    float64 on a card resolves 0 without asking the rule."""
    if device == "cpu":
        eng = WALSEngine(WALSConfig(**{**ENGINE, "dtype": dtype}),
                         device="cpu")
        eng.init(_zipf_dataset())
        assert eng.hot_widths == {"user": 0, "item": 0}
        assert eng._user_hot is None and eng._item_hot is None
        return
    eng = WALSEngine(WALSConfig(dtype=dtype, solver="cholesky"),
                     device=device)
    eng._solver = "cholesky"
    deg = _zipf_degrees(2, 26_744, 18_000_000, 1.1)
    assert hot.auto_hot_width(deg, 138_493, 64) > 0
    assert eng._resolve_hot_width(deg, 138_493) == 0


@pytest.mark.parametrize("solver,precision", [
    ("kernel", "default"), ("lu", "highest"), ("fused", "default"),
    ("fused", "highest"),
])
def test_auto_on_cuda_float32_takes_the_rule(solver, precision):
    """Float32 on a CUDA device: the rule with its H100 constants, whatever
    the solver, and the hot store's bytes (bf16 under "default", f32 under
    "highest")."""
    eng = WALSEngine(WALSConfig(nfactors=64, solver=solver,
                                matmul_precision=precision), device="cuda")
    eng._solver = solver
    for seed, rows in ((1, 138_493), (2, 26_744), (3, 800_000)):
        deg = _zipf_degrees(seed, 26_744, 18_000_000, 1.1)
        assert eng._resolve_hot_width(deg, rows) == hot.auto_hot_width(
            deg, rows, 64, store_bytes=2 if precision == "default" else 4)


def test_int_hot_width_forces_both_sides():
    eng = WALSEngine(WALSConfig(**{**ENGINE, "hot_width": 5}), device="cpu")
    eng.init(_zipf_dataset())
    assert eng.hot_widths == {"user": 5, "item": 5}
    assert len(eng._user_hot[0]) == len(eng._item_hot[0]) == 5


def _forced(widths, n_items):
    """A _resolve_hot_width for either package: the user side's width where
    the fixed side's degrees are the items' (init resolves that side with
    deg_i), the item side's otherwise."""
    def resolve(self, col_degrees, n_build_rows):
        return widths[0] if len(col_degrees) == n_items else widths[1]
    return resolve


def _run(engine_cls, config_cls, ds, **kw):
    """Per-epoch losses and final (user, item) factors."""
    cfg = config_cls(**ENGINE, **kw)
    port = engine_cls is WALSEngine
    eng = engine_cls(cfg, device="cpu") if port else engine_cls(cfg)
    losses = []
    eng.progress_cb = lambda e, loss, dt: losses.append(loss)
    eng.init(ds if port else JaxDataset(ds.user_ids, ds.item_ids, ds.values))
    eng.optimize()
    return eng, losses, [f.numpy() if port else np.asarray(f)
                         for f in (eng.user_factors, eng.item_factors)]


@pytest.mark.parametrize("widths", [(6, 0), (0, 6), (6, 2)])
def test_per_side_widths_match_qmf_tpu(monkeypatch, widths):
    """Each side with its own width: float64 factors and losses within 1e-9
    of qmf_tpu's engine with the same widths (solver "lu" there compiles in
    seconds on the CPU)."""
    ds = _zipf_dataset()
    n_items = len(np.unique(ds.item_ids))
    assert n_items != len(np.unique(ds.user_ids))
    for cls in (WALSEngine, JaxWALSEngine):
        monkeypatch.setattr(cls, "_resolve_hot_width",
                            _forced(widths, n_items))
    port, p_loss, p_f = _run(WALSEngine, WALSConfig, ds, solver="cholesky")
    assert port.hot_widths == dict(zip(("user", "item"), widths))
    for side, h in zip(("user", "item"), widths):
        state = getattr(port, f"_{side}_hot")
        assert (state is None) == (h == 0)
        assert h == 0 or len(state[0]) == h
    _, j_loss, j_f = _run(JaxWALSEngine, JaxWALSConfig, ds, solver="lu")
    np.testing.assert_allclose(p_loss, j_loss, **F64)
    for g, w in zip(p_f, j_f):
        np.testing.assert_allclose(g, w, **F64)


def test_per_side_widths_on_two_gloo_ranks(monkeypatch, tmp_path):
    """ShardedWALSEngine on two gloo CPU ranks with (user, item) widths
    (6, 2) forced (dryrun.run_jobs' ``hot_widths``): both ranks hold the
    single-device engine's factors within 1e-9, at those widths."""
    ds = _zipf_dataset()
    n_items = len(np.unique(ds.item_ids))
    widths = (6, 2)
    monkeypatch.setattr(WALSEngine, "_resolve_hot_width",
                        _forced(widths, n_items))
    _, _, want = _run(WALSEngine, WALSConfig, ds, solver="cholesky")
    train = str(tmp_path / "train.npz")
    write_ratings_npz(train, ds)
    out = str(tmp_path / "wals")
    launch.spawn(run_jobs, 2, backend="gloo", device="cpu", args=([{
        "engine": "wals", "train": train, "out": out,
        "hot_widths": list(widths),
        "config": {**ENGINE, "solver": "cholesky"}}],), deadline_s=240)
    for rank in (0, 1):
        res = read_result(out, rank)
        assert res["hot_widths"].tolist() == list(widths)
        for key, w in zip(("user_factors", "item_factors"), want):
            np.testing.assert_allclose(res[key], w, **F64)


def test_hot_micro_candidates_stop_at_the_budget():
    """The widths hot_micro times are the rule's, up to its W budget: the
    ml20m user side (138,493 rows, bf16 store) stops at 2,048, its item
    side (26,744 rows) runs to 8,192, a side of 300 columns stops at 256."""
    deg = np.ones(26_744, dtype=np.int64)
    assert hot_micro.candidates(deg, 138_493) == [0, 256, 512, 1024, 2048]
    assert hot_micro.candidates(np.ones(138_493, np.int64), 26_744) == [
        0, 256, 512, 1024, 2048, 4096, 8192]
    assert hot_micro.candidates(np.ones(300, np.int64), 10) == [0, 256]


def test_hot_micro_fit_recovers_the_model():
    """Points made by the model with known (c, F) and intercepts for each
    side give those constants back, and the picks of the fitted constants
    are the rule's."""
    demand = {"user": (_zipf_degrees(1, 26_744, 18_000_000, 1.1), 138_493),
              "item": (_zipf_degrees(2, 138_493, 18_000_000, 0.6), 26_744)}
    c, f, t0 = 1.7, 3.5e13, {"user": 12.0, "item": 20.0}
    points = []
    for side in ("user", "item"):
        for h in hot_micro.candidates(*demand[side]):
            rows, flops = hot.cost_terms(*demand[side], 64, h)
            points.append((side, h, t0[side] + 1e3 * (rows * c * 1e-9
                                                      + flops / f)))
    got = hot_micro.fit(points, 64, demand)
    assert got["ns_per_row"] == pytest.approx(c, rel=1e-6)
    assert got["flops"] == pytest.approx(f, rel=1e-6)
    for side in ("user", "item"):
        assert got["t0_ms"][side] == pytest.approx(t0[side], rel=1e-6)
        for h in hot_micro.candidates(*demand[side]):
            assert hot_micro.model_ms(got, side, demand, 64, h) == \
                pytest.approx(dict((p[1], p[2]) for p in points
                                   if p[0] == side)[h], rel=1e-9)
    assert got["rms_ms"] < 1e-6


def test_hot_micro_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert hot_micro.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
