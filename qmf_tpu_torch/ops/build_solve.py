"""Fused normal-equation build + SPD solve: the CUDA kernel and its plain version.

Port of qmf_tpu/ops/pallas_solve.py ``build_solve`` (:438-553), both of its
variants. For each row t of a width-class chunk, with the gathered
fixed-side stream yg[t] (D, k) and the weights w[t], conf[t] (D,):

    A = ytyl + sum_d rnd(rnd(w) y_d) y_d^T [+ W_a[t] @ Z]
    b = sum_d rnd(conf) y_d                [+ W_b[t] @ y_hot]
    x = A^-1 b

where rnd() rounds to the stream dtype (bf16 under
``matmul_precision="default"``, f32 under "highest") and everything else is
f32, as the TPU kernel computes it (``_accum_cold_tile`` :264-294). The
bracketed terms are the hot head (ops/hot.py), with Z = rank1_table(y_hot)
rounded to the stream dtype as als_ops.hot_tables rounds it.

On a CUDA tensor :func:`build_solve` launches ``csrc/build_solve.cu`` (see
qmf_tpu_torch/kernels.py) and raises if it cannot; on a CPU tensor it runs
:func:`build_solve_reference`. Unlike the TPU wrapper nothing is padded, and
the kernel takes no Z: it builds Z's tiles from y_hot with the same
rounding, so the caller hands it y_hot alone. A chunk with too few rows to
fill the card has each row's stream split over :func:`split_count` blocks,
and its hot head's GEMM over :func:`hot_split_count` slices of H.

``launches`` and ``launches_hot`` count calls of the two variants that
launched the kernel, one per call however many CUDA kernels it issues (the
hot head's GEMM, the build, the split's reduce + solve). CPU calls and
empty chunks do not count.
"""

from __future__ import annotations

import torch

from qmf_tpu_torch import kernels
from qmf_tpu_torch.ops import spd_solve

launches = 0  # the variant without the hot head
launches_hot = 0  # the variant with it

_STREAM_DTYPES = (torch.bfloat16, torch.float32)
# Splits: aim for this many blocks per SM; give each block of the D split
# at least this many stream rows (four of the kernel's 32-row stages) and
# each block of the hot head's H split at least this many hot columns.
SPLIT_BLOCKS_PER_SM, SPLIT_MIN_ROWS, HOT_SPLIT_MIN_COLS = 4, 128, 64


def _split(blocks: int, depth: int, min_depth: int, sms: int) -> int:
    target = SPLIT_BLOCKS_PER_SM * sms
    if blocks >= target or depth <= min_depth:
        return 1
    return max(1, min(-(-target // blocks), depth // min_depth))


def split_count(n: int, d: int, sms: int) -> int:
    """Blocks over which the kernel splits each row's D stream rows.

    1 when the chunk's n rows fill ``SPLIT_BLOCKS_PER_SM`` blocks on each of
    ``sms`` SMs, or when the stream is too short to split; otherwise enough
    slices of at least ``SPLIT_MIN_ROWS`` rows that n x S reaches that
    target. Never more than ``d``.
    """
    return _split(n, d, SPLIT_MIN_ROWS, sms)


def hot_split_count(n: int, h: int, k: int, sms: int,
                    limits: kernels.BuildSolveLimits) -> int:
    """Slices into which the hot head's GEMM splits H: by the rule of
    :func:`split_count` over its units of ``limits.hot_tile_rows`` rows x
    ``limits.hot_tile_cols`` columns (the k (k+1)/2 entries of A's lower
    triangle and the k of b are its columns), and at least enough that no
    slice is wider than ``limits.hot_max_slice``.
    """
    cols = (-(-(k * (k + 1) // 2) // limits.hot_tile_cols)
            + -(-k // limits.hot_tile_cols))
    units = -(-n // limits.hot_tile_rows) * cols
    return max(-(-h // limits.hot_max_slice),
               _split(units, h, HOT_SPLIT_MIN_COLS, sms))


def rank1_table(y_hot: torch.Tensor) -> torch.Tensor:
    """Z (H, k*k) with Z[h] = vec(y_h y_h^T), each product rounded to
    y_hot's dtype (qmf_tpu/ops/als_ops.py hot_tables :128)."""
    h, k = y_hot.shape
    return (y_hot[:, :, None] * y_hot[:, None, :]).reshape(h, k * k)


def _check(yg, w, conf, ytyl, hot, y_hot) -> None:
    if yg.dim() != 3 or yg.dtype not in _STREAM_DTYPES:
        raise ValueError(
            f"expected yg (N, D, k) bf16 or f32, got {tuple(yg.shape)} "
            f"{yg.dtype}"
        )
    n, d, k = yg.shape
    for name, t, shape in (("w", w, (n, d)), ("conf", conf, (n, d)),
                           ("ytyl", ytyl, (k, k))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(
                f"expected {name} {shape} float32, got {tuple(t.shape)} "
                f"{t.dtype}"
            )
    tensors = [w, conf, ytyl]
    if (hot is None) != (y_hot is None):
        raise ValueError("hot and y_hot come together")
    if hot is not None:
        w_a, w_b = hot
        h = y_hot.shape[0]
        for name, t, shape in (("w_a", w_a, (n, h)), ("w_b", w_b, (n, h)),
                               ("y_hot", y_hot, (h, k))):
            if tuple(t.shape) != shape or t.dtype != yg.dtype:
                raise ValueError(
                    f"expected {name} {shape} {yg.dtype} (the stream "
                    f"dtype), got {tuple(t.shape)} {t.dtype}"
                )
        tensors += [w_a, w_b, y_hot]
    for t in tensors:
        if t.device != yg.device:
            raise ValueError(f"yg on {yg.device} but an input on {t.device}")


def build_solve_reference(yg, w, conf, ytyl, hot=None, y_hot=None):
    """Plain PyTorch version of the kernel: (x (N, k), b (N, k)), f32.

    The rounded operands are upcast and multiplied in true f32 (bf16 x bf16
    products are exact in f32), so this is the kernel's arithmetic up to
    summation order. Rows whose A is not SPD come out NaN.
    """
    _check(yg, w, conf, ytyl, hot, y_hot)
    f32, sd = torch.float32, yg.dtype
    k = yg.shape[2]
    y = yg.to(f32)
    wy = (yg * w.to(sd).unsqueeze(-1)).to(f32)  # rounded to the stream dtype
    a = torch.baddbmm(ytyl, wy.transpose(1, 2), y)
    b = torch.bmm(conf.to(sd).to(f32).unsqueeze(1), y).squeeze(1)
    if hot is not None:
        w_a, w_b = hot
        a = a + (w_a.to(f32) @ rank1_table(y_hot).to(f32)).reshape(-1, k, k)
        b = b + w_b.to(f32) @ y_hot.to(f32)
    return spd_solve.solve_spd_reference(a, b), b


def build_solve(yg: torch.Tensor, w: torch.Tensor, conf: torch.Tensor,
                ytyl: torch.Tensor, hot=None, y_hot=None):
    """Build and solve each row's normal equations: (x (N, k), b (N, k)).

    yg (N, D, k) bf16 or f32 is the gathered stream; w, conf (N, D) and
    ytyl = YtY + lam I (k, k) are f32. ``hot`` = (W_a, W_b), each (N, H),
    and y_hot (H, k), of yg's dtype, add the hot head.
    """
    global launches, launches_hot
    _check(yg, w, conf, ytyl, hot, y_hot)
    if yg.device.type == "cpu":
        return build_solve_reference(yg, w, conf, ytyl, hot, y_hot)
    if yg.device.type != "cuda":
        raise ValueError(f"build_solve runs on cpu or cuda, not {yg.device}")
    n, d, k = yg.shape
    x = torch.empty((n, k), dtype=torch.float32, device=yg.device)
    b = torch.empty_like(x)
    if n == 0:
        return x, b
    limits = kernels.build_solve_limits(yg.dtype)
    if k > limits.max_k:
        raise ValueError(
            f"k={k} exceeds the build_solve kernel's shared-memory limit: "
            f"k <= {limits.max_k} ({kernels.MAX_SMEM_BYTES} bytes per block)"
        )
    sms = kernels.sm_count(yg.device)
    w_a, w_b = (None, None) if hot is None else (t.contiguous() for t in hot)
    kernels.launch_build_solve(
        yg.contiguous(), w.contiguous(), conf.contiguous(),
        ytyl.contiguous(), w_a, w_b,
        None if y_hot is None else y_hot.contiguous(), x, b,
        hot_split_count(n, 0 if y_hot is None else y_hot.shape[0], k, sms,
                        limits),
        split_count(n, d, sms),
    )
    if hot is not None:
        launches_hot += 1
    else:
        launches += 1
    return x, b
