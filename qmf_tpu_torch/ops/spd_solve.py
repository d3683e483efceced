"""Batched SPD solve: the hand-written CUDA kernel and its plain version.

Port of qmf_tpu/ops/pallas_solve.py ``solve_spd`` (:201-238). On a CUDA
tensor :func:`solve_spd` launches ``csrc/chol_solve.cu`` (see
qmf_tpu_torch/kernels.py) and raises if it cannot; on a CPU tensor it runs
:func:`solve_spd_reference`, the plain PyTorch version of the same math.
Unlike the TPU wrapper, nothing is padded: the kernel takes any k that fits
one block's shared memory, any batch size, and f32 or f64.

``launches`` counts kernel launches (CPU calls and empty batches do not
count), so a run can show that it went through the kernel.
"""

from __future__ import annotations

import torch

from qmf_tpu_torch import kernels

launches = 0


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


def solve_spd(a: torch.Tensor, b: torch.Tensor,
              layout: str = "nat") -> torch.Tensor:
    """x (B, k) with A[i] x[i] = b[i] for a (B, k, k) SPD and b (B, k).

    layout="nat" hands the kernel the batch-first tensors as they are.
    layout="t" first moves the batch last, as the TPU wrapper's batch-last
    entry does (a copy), and the kernel then reads and writes that buffer
    through its strides.
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
    max_k = kernels.chol_solve_max_k(a.dtype)
    if k > max_k:
        raise ValueError(
            f"k={k} exceeds the kernel's shared-memory limit for {a.dtype}: "
            f"k <= {max_k} ({kernels.MAX_SMEM_BYTES} bytes per block)"
        )
    if layout == "t":
        a_t = a.permute(1, 2, 0).contiguous()  # (k, k, B)
        b_t = b.t().contiguous()  # (k, B)
        x_t = torch.empty((k, bsz), dtype=b.dtype, device=b.device)
        kernels.launch_chol_solve(a_t.permute(2, 0, 1), b_t.t(), x_t.t())
        launches += 1
        return x_t.t()
    x = torch.empty((bsz, k), dtype=b.dtype, device=b.device)
    kernels.launch_chol_solve(a, b, x)
    launches += 1
    return x
