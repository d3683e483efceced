"""Hot/cold split WALS build (port of qmf_tpu/ops/hot.py).

Ratings data is power-law: the top-H hottest columns of a side cover a
large share of the nonzeros (synthetic ml20m: top-1024 items cover 59% of
entries). The split takes those entries out of the gathered stream. At
init, per side:

- entries whose column is in the top-H hot set are removed from the
  degree-packed stream (ops/packing.py packs the COLD entries only; rows
  left with zero cold entries keep a fully masked slot in the min-width
  class), and
- the hot entries become STATIC dense per-packed-row weight matrices

      W_a[row, rank] = alpha * r        (A's confidence weight)
      W_b[row, rank] = 1 + alpha * r    (b's preference weight)
      conf_hot[row]  = sum_hot (1 + alpha * r)   (loss bookkeeping)

  with zeros where unobserved (duplicates of a (row, column) sum).

Per half-epoch the fixed side's hot rows y_hot (H, k) give the rank-1 table
Z (H, k*k), Z[h] = vec(y_h y_h^T) (ops/als_ops.hot_tables), and every build
chunk adds A += (W_a @ Z).reshape(B, k, k) and b += W_b @ y_hot: the head's
exact contribution, summed in another order than the reference's
per-signal accumulation (qmf/wals/WALSEngine.cpp:266-310). The fused
build+solve kernel (ops/build_solve.py) adds the same terms in-kernel.

H is chosen for each side by :func:`auto_hot_width`, qmf_tpu's cost model in
qmf_tpu's form: the modeled build time of H is the cold stream's gathered
rows at ``gather_ns_per_row`` each plus the hot head's GEMM at
``gemm_flops``, and the candidate of least time wins (0 where none beats
the unsplit build or W would pass its memory budget). Its two constants are
the card's, not the TPU's: fitted on an H100 by
``python -m qmf_tpu_torch.tools.hot_micro``, which times the half-epochs of
both builds (split and fused) at each candidate H and fits the model's
regressors (:func:`cost_terms`) by least squares.

The numpy helpers are copies of qmf_tpu's (importing qmf_tpu.ops.hot would
import jax); ``build_hot_classes`` is the torch port of its device scatter.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

# The cost model's constants on an H100: ns for each modeled row of the
# gathered cold stream, and FLOP/s of the hot head's GEMM. Fitted by
# tools/hot_micro.py on the ml20m preset at k = 64, bf16 store, on an
# "NVIDIA H100 80GB HBM3, 700.00 W": the split build (als_ops._build_bucket,
# the hot GEMMs in f32 on operands upcast from the store) gave 1.1503 ns
# and 51.038 TFLOP/s. The fused build (csrc/build_solve.cu, the hot head in
# hot_gemm_kernel) gave 2.0572 ns and 48.987 TFLOP/s, and picks what these
# pick on both sides of both builds there (user H = 256, item H = 0, each
# the fastest measured), so one pair serves every solver.
GATHER_NS_PER_ROW = 1.1503
GEMM_FLOPS = 5.1038e13
_AUTO_CANDIDATES = (256, 512, 1024, 2048, 4096, 8192)
# Cap W_a+W_b memory (bytes per element decided by the caller's store
# dtype; the cap below assumes 2-byte bf16 storage).
_W_BUDGET_BYTES = 2 << 30
_FILL = 0.8  # the padded stream's fill, as qmf_tpu models it


def top_hot_columns(col_degrees: np.ndarray, h: int) -> np.ndarray:
    """Ids of the ``h`` highest-degree columns (stable ties)."""
    h = int(min(h, len(col_degrees)))
    if h <= 0:
        return np.zeros((0,), dtype=np.int64)
    # argpartition then sort the head: O(n + h log h)
    part = np.argpartition(col_degrees, len(col_degrees) - h)[-h:]
    return part[np.argsort(col_degrees[part], kind="stable")[::-1]]


def rank_lookup(hot_ids: np.ndarray, n_cols: int) -> np.ndarray:
    """(n_cols,) int32: column id -> rank in the hot set, or ``h`` if cold."""
    h = len(hot_ids)
    out = np.full(n_cols, h, dtype=np.int32)
    out[hot_ids] = np.arange(h, dtype=np.int32)
    return out


def _sorted_coverage(col_degrees: np.ndarray) -> Tuple[int, np.ndarray]:
    """(nnz, cumulative nonzeros of the hottest columns, hottest first)."""
    return int(col_degrees.sum()), np.cumsum(np.sort(col_degrees)[::-1])


def _terms(nnz: int, cum: np.ndarray, n_build_rows: int, k: int, h: int,
           fill: float) -> Tuple[float, int]:
    covered = int(cum[h - 1]) if h > 0 else 0
    return (nnz - covered) / fill, n_build_rows * h * (k * k + k) * 2


def cost_terms(col_degrees: np.ndarray, n_build_rows: int, k: int, h: int,
               fill: float = _FILL) -> Tuple[float, int]:
    """The model's two regressors at hot width ``h``: (the cold stream's
    modeled rows (nnz - coverage(h)) / fill, the hot GEMM's flops
    n_build_rows h (k^2 + k) 2). The modeled build seconds are
    rows * gather_ns_per_row * 1e-9 + flops / gemm_flops."""
    nnz, cum = _sorted_coverage(col_degrees)
    return _terms(nnz, cum, n_build_rows, k, h, fill)


def modeled_ms(col_degrees: np.ndarray, n_build_rows: int, k: int, h: int,
               fill: float = _FILL) -> float:
    """The modeled build ms of one side at hot width ``h`` (the quantity
    :func:`auto_hot_width` minimizes, with its default constants)."""
    rows, flops = cost_terms(col_degrees, n_build_rows, k, h, fill)
    return 1e3 * (rows * GATHER_NS_PER_ROW * 1e-9 + flops / GEMM_FLOPS)


def auto_hot_width(
    col_degrees: np.ndarray,
    n_build_rows: int,
    k: int,
    fill: float = _FILL,
    store_bytes: int = 2,
    gather_ns_per_row: float = GATHER_NS_PER_ROW,
    gemm_flops: float = GEMM_FLOPS,
) -> int:
    """Pick H minimizing modeled build time: cold gathers + hot GEMM.

    cold(H) ~ (nnz - coverage(H)) / fill * gather_ns_per_row
    hot(H)  ~ n_build_rows * H * (k^2 + k) * 2 / gemm_flops

    Returns 0 when no candidate beats the unsplit build (e.g. a flat,
    non-power-law degree distribution) or when W would blow the memory
    budget. qmf_tpu's rule with its two constants as arguments: given
    qmf_tpu's (3.4 ns, 6e13 FLOP/s, fitted on a TPU v5e) it picks what
    qmf_tpu picks.
    """
    nnz = int(col_degrees.sum())
    if nnz == 0 or n_build_rows == 0:
        return 0
    nnz, cum = _sorted_coverage(col_degrees)
    best_h, best_t = 0, nnz / fill * gather_ns_per_row * 1e-9
    for h in _AUTO_CANDIDATES:
        if h > len(cum):
            break
        if 2 * n_build_rows * h * store_bytes > _W_BUDGET_BYTES:
            break
        rows, flops = _terms(nnz, cum, n_build_rows, k, h, fill)
        t = rows * gather_ns_per_row * 1e-9 + flops / gemm_flops
        if t < best_t:
            best_h, best_t = h, t
    return best_h


def build_hot_classes(
    hot_rows,  # (nh,) build-side row ids of the hot entries
    hot_ranks,  # (nh,) their columns' ranks in [0, h)
    hot_vals,  # (nh,) ratings
    class_row_ids: Sequence[np.ndarray],  # packed row ids per width class
    n_rows: int,
    h: int,
    alpha: float,
    compute_dtype: torch.dtype,
    store_dtype: torch.dtype,
    device: str | torch.device = "cpu",
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Per-width-class (W_a, W_b, conf_hot) tensors in packed order.

    ``class_row_ids`` is each class's host-side packed row-id vector
    (padding rows hold ``n_rows``); the W rows line up 1:1 so the build
    slices W chunks alongside the class's (col_idx, values, mask). The hot
    COO comes as numpy arrays (the host pack) or as tensors on ``device``
    (the device pack's ``split_sorted_csr``).
    W_a and W_b are computed in ``compute_dtype`` and stored in
    ``store_dtype``; conf_hot stays in ``compute_dtype``.
    """
    sizes = [len(ids) for ids in class_row_ids]
    n_slots = int(sum(sizes))
    if (n_slots + 1) * h > np.iinfo(np.int32).max:
        # qmf_tpu's flat scatter index is int32; refuse the same widths so a
        # config that one package rejects, the other rejects too
        raise ValueError(
            f"hot width {h} with {n_slots} packed rows overflows the int32 "
            "scatter index; lower the hot width"
        )
    pos = np.full(n_rows + 1, n_slots, dtype=np.int64)
    off = 0
    for ids in class_row_ids:
        real = ids < n_rows
        pos[ids[real]] = off + np.nonzero(real)[0]
        off += len(ids)
    slot = torch.from_numpy(pos).to(device)[
        torch.as_tensor(hot_rows).to(device, torch.int64)]
    idx = slot * h + torch.as_tensor(hot_ranks).to(device, torch.int64)
    aw = torch.tensor(alpha, dtype=compute_dtype, device=device) * (
        torch.as_tensor(hot_vals, device=device).to(compute_dtype))
    # slot n_slots is the sink of rows that have no packed slot (index_add_
    # has no mode="drop"); it is sliced off below
    size = (n_slots + 1) * h
    w_a = torch.zeros(size, dtype=compute_dtype, device=device)
    w_a.index_add_(0, idx, aw)
    obs = torch.zeros(size, dtype=compute_dtype, device=device)
    obs.index_add_(0, idx, torch.ones_like(aw))
    conf = torch.zeros(n_slots + 1, dtype=compute_dtype, device=device)
    conf.index_add_(0, slot, 1 + aw)
    w_b = (w_a + obs).to(store_dtype).reshape(n_slots + 1, h)[:n_slots]
    w_a = w_a.to(store_dtype).reshape(n_slots + 1, h)[:n_slots]
    out = []
    off = 0
    for s in sizes:
        out.append((w_a[off:off + s], w_b[off:off + s],
                    conf[off:off + s]))
        off += s
    return out
