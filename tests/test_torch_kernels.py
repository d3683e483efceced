"""The hand-written CUDA kernel against its plain PyTorch version, on a card.

Marked ``gpu``: each test skips unless a CUDA device and nvcc are present
(``qmf_tpu_torch.kernels.available()``). This file imports no jax, so on a
machine without it run it without the repo's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import pytest
import torch

from qmf_tpu_torch import kernels
from qmf_tpu_torch.ops import spd_solve

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
