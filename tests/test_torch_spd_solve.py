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


@pytest.mark.parametrize("k", [8, 16])
def test_cholesky_solve_t_matches_pallas_interpret(k):
    """The batch-last entry on the same (k, k, B) operand as the TPU
    kernel's, which wants B a multiple of its tile."""
    a, b = _random_spd(16, k, seed=k)
    a_t, b_t = a.transpose(1, 2, 0).copy(), b.T.copy()
    want = np.asarray(pallas_solve.cholesky_solve_t(
        jnp.asarray(a_t), jnp.asarray(b_t), tb=8, interpret=True))
    got = spd_solve.cholesky_solve_t(torch.from_numpy(a_t),
                                     torch.from_numpy(b_t))
    assert got.dtype == torch.float32 and got.shape == (k, 16) == want.shape
    # both f32 with different accumulation orders, as above
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("contiguous", [True, False])
@pytest.mark.parametrize("k", [30, 64])
def test_cholesky_solve_t_matches_numpy_f64(k, contiguous):
    """No tile multiple in B or k; a resident batch-last buffer, and a
    batch-first one seen through a permuted view, read where they lie."""
    a, b = _random_spd(13, k, seed=200 + k, dtype=np.float64)
    want = np.linalg.solve(a, b[..., None])[..., 0].T
    a_t = torch.from_numpy(a).permute(1, 2, 0)
    b_t = torch.from_numpy(b).t()
    if contiguous:
        a_t, b_t = a_t.contiguous(), b_t.contiguous()
    got = spd_solve.cholesky_solve_t(a_t, b_t)
    assert got.dtype == torch.float64 and got.shape == (k, 13)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)


def test_cholesky_solve_t_shapes_and_launch_counts():
    before = (spd_solve.launches, spd_solve.launches_t)
    a, b = _random_spd(5, 8)
    a_t = torch.from_numpy(a).permute(1, 2, 0).contiguous()
    b_t = torch.from_numpy(b).t().contiguous()
    x_t = spd_solve.cholesky_solve_t(a_t, b_t)
    assert x_t.shape == (8, 5)
    # solve_spd(layout="t") is that entry between two transposes
    torch.testing.assert_close(
        x_t.t(), spd_solve.solve_spd(torch.from_numpy(a),
                                     torch.from_numpy(b), layout="t"))
    assert spd_solve.cholesky_solve_t(
        torch.zeros(8, 8, 0), torch.zeros(8, 0)).shape == (8, 0)
    with pytest.raises(ValueError, match=r"\(k, k, B\)"):  # batch-first
        spd_solve.cholesky_solve_t(torch.from_numpy(a), torch.from_numpy(b))
    with pytest.raises(ValueError, match=r"\(k, k, B\)"):
        spd_solve.cholesky_solve_t(a_t, b_t.t())
    with pytest.raises(ValueError, match="float32 or float64"):
        spd_solve.cholesky_solve_t(a_t.to(torch.float16),
                                   b_t.to(torch.float16))
    # a non-SPD system is NaN beside finite neighbours here too
    a_t[:, :, 3] = -a_t[:, :, 3]
    bad = ~torch.isfinite(spd_solve.cholesky_solve_t(a_t, b_t)).all(dim=0)
    assert bad.tolist() == [False, False, False, True, False]
    assert (spd_solve.launches, spd_solve.launches_t) == before  # CPU calls


def test_solver_micro_runs_on_cpu(capsys):
    """The probe's entry point at a small batch: the plain version on the
    host's clock, said on the line, all four columns, both entries checked;
    and its systems are benchmarks/solver_micro.py's (seed 0, same draws)."""
    from qmf_tpu_torch.tools import solver_micro

    assert solver_micro.main(["16", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("B=16: ") and "[host clock, cpu]" in out
    for column in ("solve_spd=", "solve_spd_t=", "kernel_only=",
                   "linalg_solve="):
        assert column in out
    rng = np.random.default_rng(0)
    m = rng.normal(size=(3, 64, 64)).astype(np.float32)
    a = m @ m.transpose(0, 2, 1) + 10 * np.eye(64, dtype=np.float32)
    b = rng.normal(size=(3, 64)).astype(np.float32)
    got_a, got_b = solver_micro.systems(np.random.default_rng(0), 3,
                                        torch.device("cpu"))
    np.testing.assert_array_equal(got_a.numpy(), a)
    np.testing.assert_array_equal(got_b.numpy(), b)
    assert (solver_micro.K, solver_micro.DEFAULT_SIZES) == (64, (512, 2048))


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


def test_kernel_shared_memory_limits(monkeypatch):
    """The wrapper takes the limits from the library, which alone knows its
    layout: chol_solve_limits passes the dtype and k through and returns what
    qmf_chol_solve_limits writes (the card test holds the real values)."""
    calls = []

    def fake_limits(dtype):
        def limits(k, out):
            calls.append((dtype, k))
            out[0], out[1], out[2] = 300 + dtype, 7 + k, 9 * k
            out[3], out[4], out[5] = 290 + dtype, 8, 10 * k
            return 0
        return limits

    class FakeLib:
        qmf_chol_solve_limits_f32 = staticmethod(fake_limits(0))
        qmf_chol_solve_limits_f64 = staticmethod(fake_limits(1))

    monkeypatch.setattr(kernels, "load", lambda: FakeLib)
    kernels.chol_solve_limits.cache_clear()
    try:
        assert kernels.chol_solve_limits(torch.float32, 64) == (
            300, 71, 576, 290, 8, 640)
        assert kernels.chol_solve_max_k(torch.float64) == 301
        assert kernels.chol_solve_max_k(torch.float32) == 300
        assert kernels.chol_solve_max_k(torch.float32, batch_last=True) == 290
        assert calls == [(0, 64), (1, 1), (0, 1)]
    finally:
        kernels.chol_solve_limits.cache_clear()


@pytest.mark.parametrize("k", [1, 64, 338])
def test_chol_phases_cuts_each_phase(k):
    """The phase-timing tool finds each phase it cuts in the kernel source,
    and instantiates only k's slot count."""
    from qmf_tpu_torch.tools import chol_phases

    variants = chol_phases.variant_sources(k)
    assert set(variants) == {"full", *chol_phases.CUTS}
    full = variants["full"]
    assert f"constexpr int kMaxSlots = {-(-k // 32)};" in full
    for name, (start, _) in chol_phases.CUTS.items():
        assert start in full and start not in variants[name]
        assert len(variants[name]) < len(full)
    assert "cp_async_wait_all();" in variants["load_store"]


@pytest.mark.parametrize("step", [8, 16, 24])
def test_chol_phases_sets_the_batch_last_step(step):
    """``--systems S`` builds every copy with the source's kBatchLastStep
    set to S; 0 leaves the source's own."""
    from qmf_tpu_torch.tools import chol_phases

    own = chol_phases.variant_sources(64)
    for name, text in chol_phases.variant_sources(64, step).items():
        assert f"constexpr int kBatchLastStep = {step};" in text
        assert text.count("kBatchLastStep =") == 1
        assert chol_phases._STEP in own[name]
    with pytest.raises(RuntimeError, match="no longer declares"):
        chol_phases._set("int x;", "a.cu", chol_phases._STEP, step)
