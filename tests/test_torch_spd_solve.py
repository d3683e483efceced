"""Batched SPD solve of the port (ops/spd_solve.py) against qmf_tpu's.

On the CPU ``solve_spd`` runs its plain PyTorch version; the TPU kernel runs
in Pallas interpret mode, as tests/test_pallas_solve.py runs it. The CUDA
kernel itself is held against the plain version in tests/test_torch_kernels.py
(marked gpu).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qmf_tpu.ops import pallas_solve
from qmf_tpu_torch import kernels
from qmf_tpu_torch.ops import spd_solve

torch.set_num_threads(1)


def _random_spd(bsz, k, seed=0, dtype=np.float32):
    # the generator of tests/test_pallas_solve.py
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(bsz, k, k))
    a = m @ m.transpose(0, 2, 1) + 0.1 * np.eye(k)
    b = rng.normal(size=(bsz, k))
    return a.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("layout", ["nat", "t"])
@pytest.mark.parametrize("k", [8, 16])
def test_matches_pallas_interpret(k, layout):
    a, b = _random_spd(13, k, seed=k)
    want = np.asarray(
        pallas_solve.solve_spd(
            jnp.asarray(a), jnp.asarray(b), interpret=True, layout=layout
        )
    )
    got = spd_solve.solve_spd(
        torch.from_numpy(a), torch.from_numpy(b), layout=layout
    )
    assert got.dtype == torch.float32 and got.shape == (13, k)
    # both f32 with different accumulation orders (tests/test_pallas_solve.py)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("k", [8, 30, 64])
def test_reference_matches_numpy_f64(k):
    a, b = _random_spd(9, k, seed=100 + k, dtype=np.float64)
    want = np.linalg.solve(a, b[..., None])[..., 0]
    got = spd_solve.solve_spd_reference(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


def test_non_spd_rows_are_nan():
    a, b = _random_spd(4, 8, seed=5, dtype=np.float64)
    a[2] = -a[2]  # negative definite: the first pivot is negative
    x = spd_solve.solve_spd(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.isnan(x[2]).all()
    assert np.isfinite(np.delete(x, 2, axis=0)).all()


def test_empty_batch_and_cpu_calls_do_not_count_launches():
    before = spd_solve.launches
    a, b = _random_spd(3, 8)
    spd_solve.solve_spd(torch.from_numpy(a), torch.from_numpy(b))
    x = spd_solve.solve_spd(torch.zeros(0, 8, 8), torch.zeros(0, 8))
    assert x.shape == (0, 8)
    assert spd_solve.launches == before


@pytest.mark.parametrize(
    "a_shape,b_shape,dtype,layout",
    [
        ((3, 8, 7), (3, 8), torch.float32, "nat"),
        ((3, 8, 8), (3, 7), torch.float32, "nat"),
        ((3, 8, 8), (3, 8), torch.int32, "nat"),
        ((3, 8, 8), (3, 8), torch.float32, "bogus"),
    ],
)
def test_rejects_bad_inputs(a_shape, b_shape, dtype, layout):
    with pytest.raises(ValueError):
        spd_solve.solve_spd(
            torch.ones(a_shape, dtype=dtype), torch.ones(b_shape, dtype=dtype),
            layout=layout,
        )


def test_kernel_shared_memory_limits():
    # k (k|1) + 2k elements must fit the 227 KB a block may opt into
    for dtype, item in ((torch.float32, 4), (torch.float64, 8)):
        k = kernels.chol_solve_max_k(dtype)
        assert (k * (k | 1) + 2 * k) * item <= kernels.MAX_SMEM_BYTES
        k1 = k + 1
        assert (k1 * (k1 | 1) + 2 * k1) * item > kernels.MAX_SMEM_BYTES
    assert kernels.chol_solve_max_k(torch.float32) >= 238
    assert kernels.chol_solve_max_k(torch.float64) >= 168
