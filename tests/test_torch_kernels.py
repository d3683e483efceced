"""The hand-written CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: each test skips unless a CUDA device and nvcc are present
(``qmf_tpu_torch.kernels.available()``). This file imports no jax, so on a
machine without it run it without the repo's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

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


@pytest.mark.parametrize("layout", ["nat", "t"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("k", [8, 30, 64, 128])
def test_kernel_matches_plain(cuda, k, dtype, tol, layout):
    a, b = _spd(37, k, dtype, cuda, seed=k)
    before = spd_solve.launches
    got = spd_solve.solve_spd(a, b, layout=layout)
    torch.cuda.synchronize()
    assert spd_solve.launches == before + 1
    want = spd_solve.solve_spd_reference(a, b)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_kernel_non_spd_gives_nan(cuda):
    a, b = _spd(5, 16, torch.float32, cuda)
    a[3] = -a[3]
    x = spd_solve.solve_spd(a, b)
    torch.cuda.synchronize()
    assert torch.isnan(x[3]).all()
    assert torch.isfinite(x[[0, 1, 2, 4]]).all()


def test_kernel_rejects_k_over_limit(cuda):
    k = kernels.chol_solve_max_k(torch.float64) + 1
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


@pytest.mark.parametrize("n", [1, 13, 300])
@pytest.mark.parametrize("d", [8, 320, 512])
@pytest.mark.parametrize("k", [8, 30, 64])
@pytest.mark.parametrize("h", [0, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_build_solve_matches_plain(cuda, dtype, h, k, d, n):
    args = _bs_args(n, d, k, h, dtype, cuda, seed=k + d + n)
    before = (build_solve.launches, build_solve.launches_hot)
    x, b = build_solve.build_solve(*args)
    torch.cuda.synchronize()
    after = (build_solve.launches, build_solve.launches_hot)
    assert after == (before[0] + (h == 0), before[1] + (h > 0))
    x_plain, b_plain = build_solve.build_solve_reference(*args)
    _assert_rowwise_close(b, b_plain, 2e-4)
    _assert_rowwise_close(x, x_plain, 2e-4)


def test_build_solve_non_spd_rows_are_nan(cuda):
    args = _bs_args(8, 64, 30, 0, torch.bfloat16, cuda)
    args[1][[2, 5]] = 0.0
    args[2][[2, 5]] = 0.0
    args[3] = -0.05 * torch.eye(30, device=cuda)
    x, _ = build_solve.build_solve(*args)
    torch.cuda.synchronize()
    assert (~torch.isfinite(x).all(dim=1)).tolist() == [
        i in (2, 5) for i in range(8)]


def test_build_solve_rejects_k_over_limit(cuda):
    k = kernels.build_solve_max_k() + 1
    args = _bs_args(1, 8, k, 0, torch.float32, cuda)
    with pytest.raises(ValueError, match="shared-memory limit"):
        build_solve.build_solve(*args)
