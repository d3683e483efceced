"""The port's fused build+solve (qmf_tpu_torch/ops/build_solve.py) against
qmf_tpu's.

On the CPU ``build_solve`` runs its plain version, ``build_solve_reference``.
It is held against:

- qmf_tpu's Pallas ``build_solve`` in interpret mode, both variants, at a
  tiny shape (k = N = D = H = 8; interpret mode costs ~15 s a call here):
  b to 1e-5 of its largest entry, and x by its residual;
- qmf_tpu's XLA split build (``als_ops._build_bucket``) at wider shapes,
  with the acceptance of tests/test_pallas_solve.py:167-196: b to rtol
  5e-3 and the residual |A_jax x - b_jax| / |b_jax| < 5e-3 for the bf16
  stream; 1e-5 for the f32 stream.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qmf_tpu.ops import als_ops as jax_als
from qmf_tpu.ops import pallas_solve
from qmf_tpu_torch import kernels
from qmf_tpu_torch.ops import als_ops, build_solve, spd_solve

torch.set_num_threads(1)

ALPHA, LAM = 40.0, 0.05


def _problem(seed, n, d, k, h, n_cols=None):
    """Seeded numpy inputs: a fixed-side table y, a padded class (col,
    vals, mask) and, for h > 0, hot weights over the first h columns."""
    rng = np.random.default_rng(seed)
    n_cols = n_cols or max(3 * k, h + 2 * k)
    y = rng.normal(0, 0.3, (n_cols, k)).astype(np.float32)
    col = rng.integers(h, n_cols, (n, d))
    mask = rng.random((n, d)) < 0.8
    vals = (rng.integers(1, 11, (n, d)) * 0.5).astype(np.float32)
    seen = rng.random((n, h)) < 0.3
    w_a = (ALPHA * rng.integers(1, 11, (n, h)) * 0.5 * seen).astype(
        np.float32)
    return y, col, vals, mask, w_a, (w_a + seen).astype(np.float32)


def _weights(vals, mask):
    maskf = mask.astype(np.float32)
    w = ALPHA * vals * maskf
    return w, maskf + w


def _port_args(y, col, vals, mask, w_a, w_b, stream, hot):
    """build_solve's arguments, formed as als_ops._fused_class forms them."""
    w, conf = _weights(vals, mask)
    yt = torch.from_numpy(y)
    ytyl = yt.T @ yt + LAM * torch.eye(y.shape[1])
    args = [yt.to(stream)[torch.from_numpy(col)], torch.from_numpy(w),
            torch.from_numpy(conf), ytyl, None, None]
    if hot:
        h = w_a.shape[1]
        args[4] = (torch.from_numpy(w_a).to(stream),
                   torch.from_numpy(w_b).to(stream))
        args[5] = als_ops.hot_tables(yt[:h], "default" if stream ==
                                     torch.bfloat16 else "highest")[0]
    return args


@pytest.fixture(scope="module")
def interpret_runs():
    """qmf_tpu's Pallas build_solve in interpret mode, without and with the
    hot head, on one tiny seeded problem (k = N = D = H = 8)."""
    y, col, vals, mask, w_a, w_b = _problem(0, 8, 8, 8, 8)
    w, conf = _weights(vals, mask)
    yj = jnp.asarray(y)
    ytyl = yj.T @ yj + LAM * jnp.eye(8, dtype=jnp.float32)
    yg = yj.astype(jnp.bfloat16)[jnp.asarray(col)]
    yh, z = jax_als.hot_tables(yj[:8], "default")
    runs = {
        False: pallas_solve.build_solve(yg, jnp.asarray(w), jnp.asarray(conf),
                                        ytyl, interpret=True),
        True: pallas_solve.build_solve(
            yg, jnp.asarray(w), jnp.asarray(conf), ytyl,
            hot=(jnp.asarray(w_a, jnp.bfloat16),
                 jnp.asarray(w_b, jnp.bfloat16)),
            y_hot=yh, z=z, interpret=True),
    }
    return (y, col, vals, mask, w_a, w_b), {
        hot: tuple(np.asarray(t) for t in xb) for hot, xb in runs.items()}


def _rel_residual(a, x, b):
    """max over rows of |A x - b| / |b|, in f64, with A's lower triangle
    mirrored: the matrix every solver here factors (the upper triangle
    differs from it where w y is rounded on the other side)."""
    a, x, b = (np.asarray(t, np.float64) for t in (a, x, b))
    low = np.tril(a)
    a = low + np.swapaxes(np.tril(a, -1), 1, 2)
    res = np.einsum("bkl,bl->bk", a, x) - b
    return (np.linalg.norm(res, axis=1) / np.linalg.norm(b, axis=1)).max()


@pytest.mark.parametrize("hot", [False, True])
def test_matches_pallas_interpret(interpret_runs, hot):
    """b agrees to f32 summation order. Interpret mode rounds each A
    product to bf16 (tests/test_pallas_solve.py:183-188), which cond(A)
    amplifies in x, so x is held by its residual against the port's split
    build of the same A: < 5e-3 for the interpret x, < 1e-5 for the port's."""
    problem, runs = interpret_runs
    y, col, vals, mask, w_a, w_b = problem
    args = _port_args(*problem, torch.bfloat16, hot)
    x, b = build_solve.build_solve(*args)
    x_want, b_want = runs[hot]
    assert x.dtype == b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), b_want, rtol=0,
                               atol=1e-5 * np.abs(b_want).max())
    yt = torch.from_numpy(y)
    split_hot = z = None
    if hot:
        split_hot = (*args[4], torch.zeros(8))
        z = build_solve.rank1_table(args[5])
    a_split, b_split, _ = als_ops._build_bucket(
        yt, yt.T @ yt, torch.from_numpy(col), torch.from_numpy(vals),
        torch.from_numpy(mask), ALPHA, LAM, "default", split_hot, args[5], z)
    assert _rel_residual(a_split, x_want, b_split) < 5e-3
    assert _rel_residual(a_split, x, b_split) < 1e-5


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("d", [8, 320, 512])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_matches_jax_split_build(precision, d, hot):
    """N = 37 rows, k = 16; hot cases carry H = 300 columns."""
    k, h = 16, 300 if hot else 0
    y, col, vals, mask, w_a, w_b = _problem(d + h, 37, d, k, h)
    stream = torch.bfloat16 if precision == "default" else torch.float32
    x, b = build_solve.build_solve(
        *_port_args(y, col, vals, mask, w_a, w_b, stream, hot))
    yj = jnp.asarray(y)
    jhot = yh = z = None
    if hot:
        store = jnp.bfloat16 if precision == "default" else jnp.float32
        yh, z = jax_als.hot_tables(yj[:h], precision)
        jhot = (jnp.asarray(w_a, store), jnp.asarray(w_b, store),
                jnp.zeros(37, jnp.float32))
    a_j, b_j, _ = jax_als._build_bucket(
        yj, yj.T @ yj, jnp.asarray(col), jnp.asarray(vals),
        jnp.asarray(mask), jnp.float32(ALPHA), jnp.float32(LAM), precision,
        jhot, yh, z)
    b_j = np.asarray(b_j, np.float64)
    tol = 5e-3 if precision == "default" else 1e-5
    np.testing.assert_allclose(b.numpy(), b_j, rtol=tol,
                               atol=tol * np.abs(b_j).max())
    assert _rel_residual(a_j, x, b_j) < tol


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_fused_side_matches_split_side(precision):
    """als_ops._solve_side with solver="fused" against the split path
    (build + plain solve) on the same classes, with the hot head."""
    from qmf_tpu_torch.ops import hot as hot_ops
    from qmf_tpu_torch.ops.packing import chunks_for_classes, pack_width_classes

    rng = np.random.default_rng(5)
    n_rows, n_cols, k, h = 50, 40, 8, 5
    key = np.unique(rng.integers(0, n_rows * n_cols, 700))
    rows, cols = key // n_cols, key % n_cols
    vals = rng.integers(1, 11, len(key)) * 0.5
    is_hot = cols < h  # columns 0..h-1 form the hot set, rank == id
    classes = pack_width_classes(rows[~is_hot], cols[~is_hot],
                                 vals[~is_hot], n_rows, 16,
                                 active_mask=np.bincount(rows) > 0)
    arrays = [(torch.from_numpy(c.row_ids.astype(np.int64)),
               torch.from_numpy(c.col_idx.astype(np.int64)),
               torch.from_numpy(c.values).float(), torch.from_numpy(c.mask))
              for c in classes]
    store = torch.bfloat16 if precision == "default" else torch.float32
    hot = (torch.arange(h), hot_ops.build_hot_classes(
        rows[is_hot], cols[is_hot], vals[is_hot],
        [c.row_ids for c in classes], n_rows, h, ALPHA, torch.float32,
        store))
    y = torch.from_numpy(rng.normal(0, 0.3, (n_cols, k))).float()
    chunks = chunks_for_classes(classes, 16)
    assert any(c[1].shape[0] > ch for c, ch in zip(arrays, chunks))
    x_f, loss_f = als_ops._solve_side(y, arrays, chunks, n_rows, ALPHA, LAM,
                                      "fused", precision, hot)
    x_s, loss_s = als_ops._solve_side(y, arrays, chunks, n_rows, ALPHA, LAM,
                                      "cholesky", precision, hot)
    assert x_f.dtype == torch.float32
    # the same roundings; the fused version rounds w y where the split
    # build rounds it too, and sums in another order
    np.testing.assert_allclose(x_f.numpy(), x_s.numpy(), rtol=0,
                               atol=1e-4 * float(x_s.abs().max()))
    assert float(loss_f) == pytest.approx(float(loss_s), rel=1e-5)


def test_reference_is_the_split_build_then_solve():
    """build_solve_reference equals the split path's build (rounded w y,
    f32 sums) followed by the plain SPD solve."""
    y, col, vals, mask, w_a, w_b = _problem(9, 21, 24, 8, 0)
    args = _port_args(y, col, vals, mask, w_a, w_b, torch.bfloat16, False)
    x, b = build_solve.build_solve_reference(*args)
    yt = torch.from_numpy(y)
    a_s, b_s, _ = als_ops._build_bucket(
        yt, yt.T @ yt, torch.from_numpy(col), torch.from_numpy(vals),
        torch.from_numpy(mask), ALPHA, LAM, "default")
    torch.testing.assert_close(b, b_s, rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(x, spd_solve.solve_spd_reference(a_s, b_s),
                               rtol=1e-4, atol=1e-5)


def test_cpu_calls_launch_nothing_and_empty_chunks_pass():
    args = _port_args(*_problem(1, 5, 8, 8, 4), torch.bfloat16, True)
    before = (build_solve.launches, build_solve.launches_hot)
    x, b = build_solve.build_solve(*args)
    assert x.shape == b.shape == (5, 8)
    assert torch.isfinite(x).all()
    assert (build_solve.launches, build_solve.launches_hot) == before
    empty = [args[0][:0], args[1][:0], args[2][:0], args[3], None, None]
    assert build_solve.build_solve(*empty)[0].shape == (0, 8)


def test_non_spd_rows_are_nan():
    args = _port_args(*_problem(2, 6, 32, 8, 0), torch.float32, False)
    args[1][[1, 4]] = 0.0
    args[2][[1, 4]] = 0.0
    args[3] = -LAM * torch.eye(8)
    x, _ = build_solve.build_solve(*args)
    assert (~torch.isfinite(x).all(dim=1)).tolist() == [
        i in (1, 4) for i in range(6)]


@pytest.mark.parametrize("bad,match", [
    ("stream_f64", "bf16 or f32"),
    ("w_shape", "expected w"),
    ("ytyl_dtype", "expected ytyl"),
    ("hot_without_y_hot", "together"),
    ("hot_dtype", "stream dtype"),
    ("device", "runs on cpu or cuda"),
])
def test_rejects_bad_inputs(bad, match):
    args = _port_args(*_problem(3, 4, 8, 8, 3), torch.bfloat16, True)
    if bad == "stream_f64":
        args[0] = args[0].double()
    elif bad == "w_shape":
        args[1] = args[1][:, :4]
    elif bad == "ytyl_dtype":
        args[3] = args[3].double()
    elif bad == "hot_without_y_hot":
        args[5] = None
    elif bad == "hot_dtype":
        args[4] = tuple(t.float() for t in args[4])
    else:
        args = [t.to("meta") if isinstance(t, torch.Tensor) else
                None if t is None else tuple(u.to("meta") for u in t)
                for t in args]
    with pytest.raises(ValueError, match=match):
        build_solve.build_solve(*args)


H100_SMS = 132


@pytest.mark.parametrize("n,d", [(528, 131072), (8192, 16), (4096, 4096),
                                 (31744, 64)])
def test_split_count_is_one_where_rows_fill_the_card(n, d):
    """4 blocks on each of 132 SMs: 528 rows or more run one block each."""
    assert build_solve.split_count(n, d, H100_SMS) == 1


@pytest.mark.parametrize("n,d", [(8, 131072), (16, 98304), (48, 65536),
                                 (88, 32768), (296, 8192), (1, 4096)])
def test_split_count_splits_the_wide_chunks(n, d):
    """The ml20m item side's wide chunks (packing.py caps a chunk of width
    D at 8192 * 8 / D rows) reach the target of 528 blocks, or as many as
    slices of 128 stream rows allow."""
    s = build_solve.split_count(n, d, H100_SMS)
    assert s > 1
    assert n * s >= 4 * H100_SMS or s == d // build_solve.SPLIT_MIN_ROWS
    assert d // s >= build_solve.SPLIT_MIN_ROWS


def test_split_counts_never_exceed_the_reduction_depth():
    for sms in (1, 8, 132):
        for n in (1, 2, 7, 8, 100, 527, 528, 10**5):
            for d in (0, 1, 8, 127, 128, 129, 320, 4097, 131072):
                s = build_solve.split_count(n, d, sms)
                assert 1 <= s <= max(d, 1)
                assert s == 1 or n < 4 * sms
            for h in (0, 1, 64, 65, 300, 1024, 1025, 4096):
                for lim in (BF16_LIMITS, F32_LIMITS):
                    sh = build_solve.hot_split_count(n, h, 64, sms, lim)
                    assert 1 <= sh <= max(h, 1)
                    assert -(-h // sh) <= lim.hot_max_slice


# csrc/build_solve.cu's limits (qmf_build_solve_limits), which the card
# tests read from the library: max k, widest H slice, hot tile rows, columns
BF16_LIMITS = kernels.BuildSolveLimits(229, 1024, 128, 64)
F32_LIMITS = kernels.BuildSolveLimits(209, 512, 128, 64)


@pytest.mark.parametrize("n,k,want", [(8, 64, 16), (4096, 64, 1),
                                      (512, 64, 4), (1, 8, 16)])
def test_hot_split_count_at_h1024(n, k, want):
    """H = 1024 split so that (row tiles x column tiles x H slices) reaches
    528 blocks, each with at least 64 hot columns; an f32 stream's Z tile
    holds 512 hot columns, so it takes at least two slices."""
    assert build_solve.hot_split_count(n, 1024, k, H100_SMS,
                                       BF16_LIMITS) == want
    assert build_solve.hot_split_count(n, 1024, k, H100_SMS,
                                       F32_LIMITS) == max(want, 2)
