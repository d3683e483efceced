"""Batched SPD solve: the hand-written CUDA kernel and its plain version.

Port of qmf_tpu/ops/pallas_solve.py ``solve_spd`` (:201-238) and of its
batch-last kernel entry ``cholesky_solve_t`` (:118-151). On a CUDA tensor
:func:`solve_spd` and :func:`cholesky_solve_t` launch ``csrc/chol_solve.cu``
(see qmf_tpu_torch/kernels.py) and raise if they cannot; on a CPU tensor
they run :func:`solve_spd_reference`, the plain PyTorch version of the same
math. Unlike the TPU functions, nothing is padded: the kernel takes any k
whose triangle fits one block's shared memory (the library reports the
largest), any batch size, and f32 or f64.

``launches`` counts kernel launches of either entry and ``launches_t`` those
of the batch-last entry alone (CPU calls and empty batches do not count), so
a run can show that it went through the kernel.
"""

from __future__ import annotations

import torch

from qmf_tpu_torch import kernels

launches = 0
launches_t = 0
kernels.register_counter(globals(), "launches")
kernels.register_counter(globals(), "launches_t")


def _check(a: torch.Tensor, b: torch.Tensor, layout: str) -> None:
    if layout not in ("nat", "t"):
        raise ValueError(f"unknown layout {layout!r} (expected 'nat' or 't')")
    if a.dim() != 3 or a.shape[1] != a.shape[2] or b.shape != a.shape[:2]:
        raise ValueError(
            f"expected a (B, k, k) and b (B, k), got {tuple(a.shape)} and "
            f"{tuple(b.shape)}"
        )
    if a.dtype not in (torch.float32, torch.float64) or b.dtype != a.dtype:
        raise ValueError(
            f"expected float32 or float64 a and b of one dtype, got "
            f"{a.dtype} and {b.dtype}"
        )
    if a.device != b.device:
        raise ValueError(f"a on {a.device} but b on {b.device}")


def solve_spd_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch batched SPD solve: cholesky_ex + cholesky_solve.

    Rows whose factorization fails (a non-positive pivot) come out NaN, as
    the kernel's sqrt of a negative pivot makes them.
    """
    chol, info = torch.linalg.cholesky_ex(a)
    x = torch.cholesky_solve(b.unsqueeze(-1), chol).squeeze(-1)
    return torch.where((info != 0).unsqueeze(-1), torch.nan, x)


def _check_k(k: int, dtype: torch.dtype, batch_last: bool) -> None:
    max_k = kernels.chol_solve_max_k(dtype, batch_last)
    if k > max_k:
        raise ValueError(
            f"k={k} exceeds the kernel's shared-memory limit for {dtype}: "
            f"k <= {max_k} (one system's triangle in "
            f"{kernels.MAX_SMEM_BYTES} bytes per block)"
        )


def cholesky_solve_t(a_t: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """x_t (k, B) with A_t[:, :, i] x_t[:, i] = b_t[:, i], for a_t (k, k, B)
    SPD with the batch last and b_t (k, B): qmf_tpu's ``cholesky_solve_t``.

    The operands are read where they lie and x_t is written batch-last too:
    no transpose or copy on the way. Each A is symmetric and only
    ``a_t[r, c]`` with c <= r is read. Unlike the TPU function, B need not
    be a multiple of a tile and k not of 8: any B, and any k the kernel
    fits. The kernel reads fastest where the batch stride is 1 (a contiguous
    (k, k, B) buffer); other strides give the same result.
    """
    global launches, launches_t
    if (a_t.dim() != 3 or a_t.shape[0] != a_t.shape[1]
            or b_t.shape != a_t.shape[1:]):
        raise ValueError(
            f"expected a_t (k, k, B) and b_t (k, B), got {tuple(a_t.shape)} "
            f"and {tuple(b_t.shape)}"
        )
    _check(a_t.permute(2, 0, 1), b_t.t(), "t")
    if a_t.device.type == "cpu":
        return solve_spd_reference(a_t.permute(2, 0, 1), b_t.t()).t()
    if a_t.device.type != "cuda":
        raise ValueError(
            f"cholesky_solve_t runs on cpu or cuda, not {a_t.device}")
    k, bsz = b_t.shape
    x_t = torch.empty((k, bsz), dtype=b_t.dtype, device=b_t.device)
    if bsz == 0:
        return x_t
    _check_k(k, a_t.dtype, batch_last=True)
    kernels.launch_chol_solve_t(a_t, b_t, x_t)
    launches += 1
    launches_t += 1
    return x_t


def solve_spd(a: torch.Tensor, b: torch.Tensor,
              layout: str = "nat") -> torch.Tensor:
    """x (B, k) with A[i] x[i] = b[i] for a (B, k, k) SPD and b (B, k).

    layout="nat" hands the kernel the batch-first tensors as they are.
    layout="t" is the TPU wrapper's other route: it moves the batch last
    (a copy of A and of b, this function's own), calls
    :func:`cholesky_solve_t` on the result and returns its x transposed.
    """
    global launches
    _check(a, b, layout)
    if a.device.type == "cpu":
        return solve_spd_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"solve_spd runs on cpu or cuda, not {a.device}")
    bsz, k = b.shape
    if bsz == 0:
        return torch.empty((0, k), dtype=b.dtype, device=b.device)
    if layout == "t":
        return cholesky_solve_t(a.permute(1, 2, 0).contiguous(),
                                b.t().contiguous()).t()
    _check_k(k, a.dtype, batch_last=False)
    x = torch.empty((bsz, k), dtype=b.dtype, device=b.device)
    kernels.launch_chol_solve(a, b, x)
    launches += 1
    return x
