"""The port's ALS ops (qmf_tpu_torch/ops/als_ops.py) against qmf_tpu's.

Same packed inputs, made with numpy from a seed, go through both. float64
results agree to rounding (rtol 1e-9); the f32 bf16 build ("default"
precision) agrees to f32 rounding of its f32 accumulation.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qmf_tpu.ops import als_ops as jax_ops
from qmf_tpu_torch.ops import als_ops
from qmf_tpu_torch.ops.packing import chunks_for_classes, pack_width_classes

torch.set_num_threads(1)

ALPHA, LAM = 40.0, 0.05


def _problem(seed=0, n_rows=40, n_cols=30, k=8, nnz=500, batch_rows=16):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n_rows * n_cols, nnz))
    rows, cols = key // n_cols, key % n_cols
    vals = rng.integers(1, 11, len(key)) * 0.5
    classes = pack_width_classes(rows, cols, vals, n_rows, batch_rows,
                                 width_grid="pow2_15")
    y = rng.normal(scale=0.3, size=(n_cols, k))
    return y, classes, chunks_for_classes(classes, batch_rows), (rows, cols, vals)


def _torch_bucket(c, dtype):
    return (torch.from_numpy(c.row_ids.astype(np.int64)),
            torch.from_numpy(c.col_idx.astype(np.int64)),
            torch.from_numpy(c.values).to(dtype),
            torch.from_numpy(c.mask))


def _jax_bucket(c, dtype):
    return (jnp.asarray(c.row_ids), jnp.asarray(c.col_idx),
            jnp.asarray(c.values, dtype=dtype), jnp.asarray(c.mask))


def test_gramian_and_scores_f64():
    y, *_ = _problem()
    u = np.random.default_rng(1).normal(size=(5, y.shape[1]))
    np.testing.assert_allclose(
        als_ops.gramian(torch.from_numpy(y)).numpy(),
        np.asarray(jax_ops.gramian(jnp.asarray(y))), rtol=1e-12,
    )
    idx = np.array([4, 0, 2])
    got = als_ops.compute_scores(torch.from_numpy(u), torch.from_numpy(y),
                                 user_idx=torch.from_numpy(idx))
    want = jax_ops.compute_scores(jnp.asarray(u), jnp.asarray(y),
                                  user_idx=jnp.asarray(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("cls", [0, -1])
def test_build_bucket_f64(cls):
    y, classes, _, _ = _problem()
    c = classes[cls]
    yt, ytyt = torch.from_numpy(y), als_ops.gramian(torch.from_numpy(y))
    _, col, val, mask = _torch_bucket(c, torch.float64)
    got = als_ops._build_bucket(yt, ytyt, col, val, mask, ALPHA, LAM, "highest")
    yj = jnp.asarray(y)
    _, colj, valj, maskj = _jax_bucket(c, jnp.float64)
    want = jax_ops._build_bucket(yj, jax_ops.gramian(yj), colj, valj, maskj,
                                 ALPHA, LAM, "highest")
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-12)


def test_build_bucket_default_precision_f32():
    """bf16 operands, f32 accumulation: A stays f32 and matches qmf_tpu's
    DEFAULT-precision build; it differs from the fp32 build by bf16
    rounding, so the bf16 cast really happened."""
    y, classes, _, _ = _problem(seed=2)
    y32 = y.astype(np.float32)
    c = classes[-1]
    yt = torch.from_numpy(y32)
    _, col, val, mask = _torch_bucket(c, torch.float32)
    a, b, conf = als_ops._build_bucket(yt, als_ops.gramian(yt), col, val,
                                       mask, ALPHA, LAM, "default")
    assert a.dtype == b.dtype == conf.dtype == torch.float32
    yj = jnp.asarray(y32)
    _, colj, valj, maskj = _jax_bucket(c, jnp.float32)
    wa, wb, wc = jax_ops._build_bucket(
        yj, jax_ops.gramian(yj), colj, valj, maskj,
        jnp.float32(ALPHA), jnp.float32(LAM), "default",
    )
    scale = float(np.abs(np.asarray(wa)).max())
    np.testing.assert_allclose(a.numpy(), np.asarray(wa), atol=1e-5 * scale)
    np.testing.assert_allclose(b.numpy(), np.asarray(wb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(conf.numpy(), np.asarray(wc), rtol=1e-6)
    a_hi, _, _ = als_ops._build_bucket(yt, als_ops.gramian(yt), col, val,
                                       mask, ALPHA, LAM, "highest")
    assert float((a - a_hi).abs().max()) > 1e-4 * scale


@pytest.mark.parametrize("solver", ["cholesky", "kernel", "lu"])
@pytest.mark.parametrize("chunked", [False, True])
def test_solve_bucket_body_f64(solver, chunked):
    y, classes, _, _ = _problem(seed=4)
    c, chunk_b = classes[0], 8
    yt = torch.from_numpy(y)
    _, col, val, mask = _torch_bucket(c, torch.float64)
    x, loss = als_ops._solve_bucket_body(
        yt, als_ops.gramian(yt), col, val, mask, ALPHA, LAM, solver,
        chunk_b=chunk_b if chunked else None,
    )
    if chunked:
        assert chunk_b < col.shape[0]  # the chunk loop really ran
    yj = jnp.asarray(y)
    _, colj, valj, maskj = _jax_bucket(c, jnp.float64)
    xj, lossj = jax_ops._solve_bucket_body(
        yj, jax_ops.gramian(yj), colj, valj, maskj, ALPHA, LAM, "lu",
    )
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(loss.numpy(), np.asarray(lossj), rtol=1e-9,
                               atol=1e-12)


def test_solve_side_matches_naive_oracle_and_drops_padding():
    y, classes, chunks, (rows, cols, vals) = _problem(seed=6, n_rows=37)
    arrays = [_torch_bucket(c, torch.float64) for c in classes]
    assert any((c.row_ids == 37).any() for c in classes)  # padding rows exist
    x, loss = als_ops._solve_side(torch.from_numpy(y), arrays, chunks, 37,
                                  ALPHA, LAM, "cholesky", "highest")
    assert x.shape == (37, y.shape[1])
    total = 0.0
    for r in range(37):
        sel = rows == r
        xr, lr = als_ops.naive_reference_solve(y, cols[sel], vals[sel], ALPHA,
                                               LAM)
        np.testing.assert_allclose(x[r].numpy(), xr, rtol=1e-9, atol=1e-12)
        total += lr
    assert float(loss) == pytest.approx(total, rel=1e-9)


def test_naive_reference_solve_is_the_reference_copy():
    y, _, _, (rows, cols, vals) = _problem(seed=8)
    sel = rows == rows[0]
    got = als_ops.naive_reference_solve(y, cols[sel], vals[sel], ALPHA, LAM)
    want = jax_ops.naive_reference_solve(y, cols[sel], vals[sel], ALPHA, LAM)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_train_epoch_matches_jax_f64():
    rng = np.random.default_rng(9)
    n_u, n_i, k = 30, 20, 6
    key = np.unique(rng.integers(0, n_u * n_i, 200))
    rows, cols = key // n_i, key % n_i
    vals = rng.integers(1, 11, len(key)) * 0.5
    n_u, n_i = int(rows.max()) + 1, int(cols.max()) + 1
    ucl = pack_width_classes(rows, cols, vals, n_u, 16)
    icl = pack_width_classes(cols, rows, vals, n_i, 16)
    uch, ich = chunks_for_classes(ucl, 16), chunks_for_classes(icl, 16)
    v0 = rng.uniform(-0.01, 0.01, size=(n_i, k))
    got = als_ops.train_epoch(
        None, torch.from_numpy(v0),
        [_torch_bucket(c, torch.float64) for c in ucl],
        [_torch_bucket(c, torch.float64) for c in icl],
        ALPHA, LAM, "cholesky", "highest", n_u, n_i, uch, ich,
    )
    want = jax_ops.train_epoch(
        jnp.zeros((n_u, k)), jnp.asarray(v0),
        [_jax_bucket(c, jnp.float64) for c in ucl],
        [_jax_bucket(c, jnp.float64) for c in icl],
        jnp.float64(ALPHA), jnp.float64(LAM), solver="lu",
        precision="highest", n_users=n_u, n_items=n_i,
        user_chunks=tuple(uch), item_chunks=tuple(ich),
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-12)
