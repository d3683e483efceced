"""The hand-written CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: each test skips unless a CUDA device and nvcc are present
(``qmf_tpu_torch.kernels.available()``). This file imports no jax, so on a
machine without it run it without the repo's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import itertools

import pytest
import torch

from qmf_tpu_torch import kernels
from qmf_tpu_torch.ops import build_solve, spd_solve

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not kernels.available():
        pytest.skip("needs a CUDA device and nvcc (kernels.available() is False)")
    return torch.device("cuda")


def _spd(bsz, k, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    m = torch.randn(bsz, k, k, generator=g, dtype=torch.float64)
    a = m @ m.transpose(1, 2) / k + torch.eye(k, dtype=torch.float64)
    b = torch.randn(bsz, k, generator=g, dtype=torch.float64)
    return a.to(device, dtype), b.to(device, dtype)


_TOL = {torch.float32: 2e-4, torch.float64: 1e-10}


def _check_chol(a, b, layout, tol):
    before = spd_solve.launches
    got = spd_solve.solve_spd(a, b, layout=layout)
    torch.cuda.synchronize()
    assert spd_solve.launches == before + 1
    want = spd_solve.solve_spd_reference(a, b)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("layout", ["nat", "t"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("k", [1, 8, 30, 31, 33, 64, 65, 128, "max"])
def test_kernel_matches_plain(cuda, k, dtype, tol, layout):
    if k == "max":
        k = kernels.chol_solve_max_k(dtype)
    a, b = _spd(37, k, dtype, cuda, seed=k)
    _check_chol(a, b, layout, tol)


@pytest.mark.parametrize("layout", ["nat", "t"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [30, 64])
@pytest.mark.parametrize("bsz", [1, "per_block+1", 4097])
def test_kernel_partial_last_block(cuda, bsz, k, dtype, layout):
    """Batches that leave the last block's systems partly unused."""
    per_block = kernels.chol_solve_limits(dtype, k).systems_per_block
    if bsz == "per_block+1":
        bsz = per_block + 1
    a, b = _spd(bsz, k, dtype, cuda, seed=bsz + k)
    _check_chol(a, b, layout, _TOL[dtype])


def test_kernel_non_spd_gives_nan(cuda):
    a, b = _spd(5, 16, torch.float32, cuda)
    a[3] = -a[3]
    x = spd_solve.solve_spd(a, b)
    torch.cuda.synchronize()
    assert torch.isnan(x[3]).all()
    assert torch.isfinite(x[[0, 1, 2, 4]]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_non_spd_rows_share_a_block(cuda, dtype):
    """Non-SPD systems come out NaN, and the SPD systems of their block stay
    finite and right."""
    k = 64
    per_block = kernels.chol_solve_limits(dtype, k).systems_per_block
    assert per_block >= 2
    bsz = 2 * per_block + 3
    a, b = _spd(bsz, k, dtype, cuda, seed=7)
    bad = [1, per_block, per_block + 2, bsz - 1]
    a[bad[0]] = -a[bad[0]]
    a[bad[1], 40, 40] = -5.0  # a negative pivot late in the factor
    a[bad[2]] = 0.0
    a[bad[3], 0, 0] = 0.0  # a zero first pivot
    x = spd_solve.solve_spd(a, b)
    torch.cuda.synchronize()
    good = [i for i in range(bsz) if i not in bad]
    assert (~torch.isfinite(x).all(dim=1)).nonzero().flatten().tolist() == bad
    torch.testing.assert_close(x[good], spd_solve.solve_spd_reference(
        a[good], b[good]), rtol=_TOL[dtype], atol=_TOL[dtype])


@pytest.mark.parametrize("dtype,today", [(torch.float32, 239),
                                         (torch.float64, 169)])
def test_chol_solve_limits(cuda, dtype, today):
    """The library's max k is no lower than the block-per-system kernel's
    (k (k|1) + 2k elements per block), every k up to it has at least one
    system per block, and k = 64 holds several."""
    limits = kernels.chol_solve_limits(dtype)
    assert limits.max_k >= today
    for k in range(1, limits.max_k + 1):
        at_k = kernels.chol_solve_limits(dtype, k)
        assert at_k.max_k == limits.max_k and at_k.systems_per_block >= 1
        assert at_k.systems_per_block * at_k.system_bytes <= kernels.MAX_SMEM_BYTES
    assert kernels.chol_solve_limits(dtype, limits.max_k + 1).systems_per_block == 0
    assert kernels.chol_solve_limits(dtype, 64).systems_per_block >= 2


def test_kernel_rejects_k_over_limit(cuda):
    k = kernels.chol_solve_limits(torch.float64).max_k + 1
    a, b = _spd(1, k, torch.float64, cuda)
    with pytest.raises(ValueError, match="shared-memory limit"):
        spd_solve.solve_spd(a, b)


def _bs_args(n, d, k, h, dtype, device, seed=0):
    """Seeded build_solve arguments: WALS-like weights (40 r on ~80% of the
    slots) over the gathered rows of a random table; for h > 0 a hot head
    observed at ~30% density."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_cols = 4 * k + 64
    y = 0.3 * torch.randn(n_cols, k, generator=g)
    col = torch.randint(0, n_cols, (n, d), generator=g)
    mask = (torch.rand(n, d, generator=g) < 0.8).float()
    w = 20.0 * torch.randint(1, 11, (n, d), generator=g) * mask
    args = [y[col].to(dtype), w, mask + w,
            y.T @ y + 0.05 * torch.eye(k), None, None]
    if h:
        seen = (torch.rand(n, h, generator=g) < 0.3).float()
        w_a = 20.0 * torch.randint(1, 11, (n, h), generator=g) * seen
        args[4] = (w_a.to(dtype), (w_a + seen).to(dtype))
        args[5] = (0.3 * torch.randn(h, k, generator=g)).to(dtype)
    return [None if a is None else
            tuple(t.to(device) for t in a) if isinstance(a, tuple) else
            a.to(device) for a in args]


def _assert_rowwise_close(got, want, tol):
    """|got - want| <= tol * max(1, max |want| of the row), row by row:
    both sum in f32 in different orders."""
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    assert float(((got - want).abs() / scale).max()) <= tol


# (n, d, k, h): the grid of every n x d x k x h; then the D split (few
# rows, wide D: S > 1); then widths no split or 16 divides, split (5 rows)
# and not (700 rows, one block per row), with k = 128 (eight 16-row MMA
# tiles, several 64-wide hot tiles) and H = 1024.
_BS_CASES = [
    *itertools.product((1, 13, 300), (8, 320, 512), (8, 30, 64), (0, 300)),
    *((*nd, k, h) for nd, k, h in itertools.product(
        ((1, 4096), (8, 32768)), (30, 64), (0, 300))),
    *((*nd, k, h) for nd, k, h in itertools.product(
        ((5, 4097), (700, 320), (700, 448)), (8, 30, 64, 128),
        (0, 300, 1024))),
]


@pytest.mark.parametrize("n,d,k,h", _BS_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_build_solve_matches_plain(cuda, dtype, n, d, k, h):
    args = _bs_args(n, d, k, h, dtype, cuda, seed=k + d + n)
    before = (build_solve.launches, build_solve.launches_hot)
    x, b = build_solve.build_solve(*args)
    torch.cuda.synchronize()
    after = (build_solve.launches, build_solve.launches_hot)
    assert after == (before[0] + (h == 0), before[1] + (h > 0))
    x_plain, b_plain = build_solve.build_solve_reference(*args)
    _assert_rowwise_close(b, b_plain, 2e-4)
    _assert_rowwise_close(x, x_plain, 2e-4)


@pytest.mark.parametrize("h", [0, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_build_solve_split_is_deterministic(cuda, dtype, h):
    """A split chunk (partials reduced in slice order, no atomics) gives
    the same bits on every call."""
    n, d = 8, 32768
    assert build_solve.split_count(n, d, kernels.sm_count(cuda)) > 1
    args = _bs_args(n, d, 64, h, dtype, cuda, seed=3)
    first = build_solve.build_solve(*args)
    second = build_solve.build_solve(*args)
    torch.cuda.synchronize()
    for u, v in zip(first, second):
        assert torch.equal(u, v)


def test_build_solve_non_spd_rows_are_nan(cuda):
    args = _bs_args(8, 64, 30, 0, torch.bfloat16, cuda)
    args[1][[2, 5]] = 0.0
    args[2][[2, 5]] = 0.0
    args[3] = -0.05 * torch.eye(30, device=cuda)
    x, _ = build_solve.build_solve(*args)
    torch.cuda.synchronize()
    assert (~torch.isfinite(x).all(dim=1)).tolist() == [
        i in (2, 5) for i in range(8)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_build_solve_rejects_k_over_limit(cuda, dtype):
    k = kernels.build_solve_max_k(dtype) + 1
    args = _bs_args(1, 8, k, 0, dtype, cuda)
    with pytest.raises(ValueError, match="shared-memory limit"):
        build_solve.build_solve(*args)


@pytest.mark.parametrize("h", [0, 300])
@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, (229, 1024, 128, 64)), (torch.float32, (209, 512, 128, 64))])
def test_build_solve_runs_at_its_limits(cuda, dtype, want, h):
    """The library reports the limits tests/test_torch_build_solve.py
    assumes, and its launch accepts them: k at the largest it takes, with
    the stream split, and a hot head one column wider than a slice."""
    limits = kernels.build_solve_limits(dtype)
    assert tuple(limits) == want
    x, b = build_solve.build_solve(
        *_bs_args(2, 4096, limits.max_k, h, dtype, cuda))
    wide = limits.hot_max_slice + 1
    x_hot, _ = build_solve.build_solve(*_bs_args(3, 40, 16, wide, dtype, cuda))
    torch.cuda.synchronize()
    assert build_solve.hot_split_count(3, wide, 16, kernels.sm_count(cuda),
                                       limits) >= 2
    for t in (x, b, x_hot):
        assert torch.isfinite(t).all()
