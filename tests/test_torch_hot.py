"""The port's hot/cold split (qmf_tpu_torch/ops/hot.py) against qmf_tpu's.

The numpy helpers are copies and must agree exactly. The W tables are
scatter-adds of the same values, exact in f64 and after the same casts in
f32/bf16. The split build agrees with qmf_tpu's to 1e-9 in f64, and so do
whole hot-split engines, per epoch. The fused f32 engine (its plain version
on the CPU) is held against qmf_tpu's f32 engine at the same hot width: to
1e-5 under "highest", and within twice qmf_tpu's own bf16-vs-f64 gap under
"default".
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qmf_tpu.config import WALSConfig as JaxWALSConfig
from qmf_tpu.data.dataset import Dataset
from qmf_tpu.models.wals import WALSEngine as JaxWALSEngine
from qmf_tpu.ops import als_ops as jax_als
from qmf_tpu.ops import hot as jax_hot
from qmf_tpu_torch.config import WALSConfig
from qmf_tpu_torch.models import WALSEngine
from qmf_tpu_torch.ops import als_ops, hot

torch.set_num_threads(1)

K = 8


def _zipf_dataset(seed, n_users=60, n_items=40, nnz=600):
    """Power-law column popularity (tests/test_hot.py's generator, with
    duplicates removed by np.unique instead of a set loop)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_items + 1)
    key = np.unique(rng.integers(0, n_users, nnz) * n_items
                    + rng.choice(n_items, size=nnz, p=p / p.sum()))
    vals = rng.uniform(0.5, 5.0, size=len(key)).round(1)
    return Dataset(key // n_items + 1, key % n_items + 1, vals)


def _all_hot_dataset():
    # hot width 2 covers items {1, 2}, i.e. every entry (tests/test_hot.py)
    return Dataset(np.array([1, 1, 2, 2, 3]), np.array([1, 2, 1, 2, 1]),
                   np.array([1.0, 2.0, 3.0, 1.0, 2.0]))


@pytest.mark.parametrize("h", [0, 1, 3, 6, 99])
def test_top_hot_columns_and_rank_lookup_match(h):
    deg = np.random.default_rng(h).integers(0, 5, 50)  # many ties
    got = hot.top_hot_columns(deg, h)
    want = jax_hot.top_hot_columns(deg, h)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hot.rank_lookup(got, 50),
                                  jax_hot.rank_lookup(want, 50))


@pytest.mark.parametrize("case", ["flat", "powerlaw", "budget", "empty"])
def test_auto_hot_width_matches(case):
    deg = np.full(200_000, 50, dtype=np.int64)
    rows, k = 500_000, 64
    if case != "flat":
        deg[:10] = 9_000_000
    if case == "budget":
        rows = 10_000_000
    if case == "empty":
        deg[:] = 0
    got = hot.auto_hot_width(deg, rows, k)
    assert got == jax_hot.auto_hot_width(deg, rows, k)
    if case == "powerlaw":
        assert got >= 256


@pytest.mark.parametrize("compute,store", [
    ("float64", "float64"), ("float32", "float32"), ("float32", "bfloat16"),
])
def test_build_hot_classes_matches(compute, store):
    rng = np.random.default_rng(1)
    n_rows, h = 30, 7
    # duplicates of a (row, rank) pair sum; row 29 has no packed slot and
    # lands in the sink
    hot_rows = np.concatenate([rng.integers(0, 29, 120), [3, 3, 29]])
    hot_ranks = np.concatenate([rng.integers(0, h, 120), [2, 2, 0]])
    vals = rng.integers(1, 11, len(hot_rows)) * 0.5
    ids = np.arange(29)
    class_ids = [np.append(ids[:12], [n_rows] * 4),
                 np.append(ids[12:], [n_rows] * 3)]
    got = hot.build_hot_classes(
        hot_rows, hot_ranks, vals, class_ids, n_rows, h, 4.0,
        getattr(torch, compute), getattr(torch, store))
    col_rank = jnp.arange(h, dtype=jnp.int32)  # hot column id == rank here
    want = jax_hot.build_hot_classes(
        jnp.asarray(hot_rows, jnp.int32), jnp.asarray(hot_ranks, jnp.int32),
        jnp.asarray(vals, getattr(jnp, compute)), col_rank, class_ids, n_rows,
        h, 4.0, getattr(jnp, compute), getattr(jnp, store))
    assert len(got) == len(want) == 2
    for g_cls, w_cls in zip(got, want):
        for g, w in zip(g_cls, w_cls):
            assert g.dtype == getattr(torch, str(w.dtype))
            np.testing.assert_array_equal(g.to(torch.float64).numpy(),
                                          np.asarray(w, np.float64))
    assert float(got[0][0][3].sum()) > 0  # the duplicated pair is in


def test_build_hot_classes_refuses_int32_overflow():
    with pytest.raises(ValueError, match="int32"):
        hot.build_hot_classes(np.zeros(1), np.zeros(1), np.ones(1),
                              [np.arange(70_000)], 70_000, 40_000, 1.0,
                              torch.float32, torch.float32)


@pytest.mark.parametrize("precision,dtype", [
    ("default", "float32"), ("highest", "float32"), ("highest", "float64"),
])
def test_hot_tables_match(precision, dtype):
    y = np.random.default_rng(2).normal(0, 0.3, (11, K))
    yh, z = als_ops.hot_tables(torch.from_numpy(y).to(getattr(torch, dtype)),
                               precision)
    yh_j, z_j = jax_als.hot_tables(jnp.asarray(y, getattr(jnp, dtype)),
                                   precision)
    assert str(yh.dtype).split(".")[1] == str(yh_j.dtype)
    for g, w in ((yh, yh_j), (z, z_j)):
        np.testing.assert_array_equal(g.to(torch.float64).numpy(),
                                      np.asarray(w, np.float64))


@pytest.mark.parametrize("precision,dtype,rtol", [
    ("highest", "float64", 1e-9), ("default", "float32", 1e-5),
])
def test_build_bucket_with_hot_matches(precision, dtype, rtol):
    """The split path's hot GEMMs (als_ops._build_bucket :197-206)."""
    rng = np.random.default_rng(3)
    n, d, h, n_cols = 13, 16, 40, 90
    y = rng.normal(0, 0.3, (n_cols, K))
    col = rng.integers(h, n_cols, (n, d))
    mask = rng.random((n, d)) < 0.7
    vals = rng.integers(1, 11, (n, d)) * 0.5
    seen = rng.random((n, h)) < 0.3
    w_a = 40.0 * rng.integers(1, 11, (n, h)) * 0.5 * seen
    store = "bfloat16" if precision == "default" else dtype
    tdt, sdt = getattr(torch, dtype), getattr(torch, store)
    yt = torch.from_numpy(y).to(tdt)
    y_hot, z = als_ops.hot_tables(yt[:h], precision)
    got = als_ops._build_bucket(
        yt, als_ops.gramian(yt), torch.from_numpy(col),
        torch.from_numpy(vals).to(tdt), torch.from_numpy(mask), 40.0, 0.05,
        precision, (torch.from_numpy(w_a).to(sdt),
                    torch.from_numpy(w_a + seen).to(sdt),
                    torch.from_numpy(seen.sum(1) + w_a.sum(1)).to(tdt)),
        y_hot, z)
    jdt, jsdt = getattr(jnp, dtype), getattr(jnp, store)
    yj = jnp.asarray(y, jdt)
    yh_j, z_j = jax_als.hot_tables(yj[:h], precision)
    want = jax_als._build_bucket(
        yj, jax_als.gramian(yj), jnp.asarray(col), jnp.asarray(vals, jdt),
        jnp.asarray(mask), jdt(40.0), jdt(0.05), precision,
        (jnp.asarray(w_a, jsdt), jnp.asarray(w_a + seen, jsdt),
         jnp.asarray(seen.sum(1) + w_a.sum(1), jdt)), yh_j, z_j)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=rtol * np.abs(w).max())


def _run(engine_cls, config_cls, ds, hot_width, nepochs=3, **kw):
    """Per-epoch losses and final (user, item) factors of one engine."""
    cfg = config_cls(nepochs=nepochs, nfactors=K, confidence_weight=4.0,
                     init_distribution_bound=0.1, init_seed=7, batch_rows=32,
                     hot_width=hot_width, **kw)
    port = engine_cls is WALSEngine
    if port:  # one progress_cb a epoch, as the JAX runs' fuse_epoch=False
        cfg.fuse_epoch = False
    eng = engine_cls(cfg, device="cpu") if port else engine_cls(cfg)
    losses = []
    eng.progress_cb = lambda e, loss, dt: losses.append(loss)
    eng.init(ds)
    eng.optimize()
    return losses, [f.numpy() if port else np.asarray(f)
                    for f in (eng.user_factors, eng.item_factors)]


def _jax_run(ds, hot_width, **kw):
    # solver="lu" compiles in seconds on the CPU; the f32 blocked
    # "cholesky" takes ~45 s here
    return _run(JaxWALSEngine, JaxWALSConfig, ds, hot_width, solver="lu",
                fuse_epoch=False, **kw)


@pytest.mark.parametrize("hot_width,dataset", [
    (6, lambda: _zipf_dataset(3)), (2, _all_hot_dataset),
])
def test_f64_hot_split_engine_matches_jax(hot_width, dataset):
    ds = dataset()
    p_loss, p_f = _run(WALSEngine, WALSConfig, ds, hot_width,
                       dtype="float64", solver="cholesky")
    j_loss, j_f = _jax_run(ds, hot_width, dtype="float64")
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-9, atol=1e-12)
    for g, w in zip(p_f, j_f):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12)


def test_f32_fused_engine_matches_jax():
    """solver="fused" (its plain version here) against qmf_tpu's f32
    engine at the same hot width. Under "highest" both are f32 throughout
    and agree to 1e-5. Under "default" both round the build's operands to
    bf16; a last-bit f32 difference can flip one bf16 rounding and the next
    epochs carry it, so the two runs are held to the gap between qmf_tpu's
    own bf16 run and its f64 run: within twice that gap, factor by factor,
    and losses within 2e-3."""
    ds = _zipf_dataset(4)
    _, f64 = _jax_run(ds, 6, dtype="float64")
    for precision in ("highest", "default"):
        p_loss, p_f = _run(WALSEngine, WALSConfig, ds, 6, solver="fused",
                           matmul_precision=precision)
        j_loss, j_f = _jax_run(ds, 6, matmul_precision=precision)
        if precision == "highest":
            np.testing.assert_allclose(p_loss, j_loss, rtol=1e-5)
            for g, w in zip(p_f, j_f):
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=1e-5 * np.abs(w).max())
            continue
        np.testing.assert_allclose(p_loss, j_loss, rtol=2e-3)
        for g, w, exact in zip(p_f, j_f, f64):
            gap = np.abs(w - exact).max()
            assert 0 < gap < 1e-2 * np.abs(exact).max()
            assert np.abs(g - w).max() <= 2 * gap
