"""Weighted ALS (Hu, Koren and Volinsky's implicit feedback), plainly.

For each row u with ratings r_uj of the fixed side's rows y_j, alpha the
confidence weight and lambda the regularization:

    A_u = Y^T Y + sum_j alpha r_uj y_j y_j^T + lambda I
    b_u = sum_j (1 + alpha r_uj) y_j,          x_u = A_u^-1 b_u
    loss_u = sum_j (1 + alpha r_uj) - x_u . b_u - lambda |x_u|^2

(qmf's WALSEngine.cpp; the loss is qmf's sum(conf) - 2 x.b + x^T A0 x at
the solution). An epoch solves the users given the items, then the items
given the users, and reports the item side's loss over n_users * n_items.
Rows are grouped by degree into power-of-two widths, so that a group's
A is one batched product; dense indices are the ranks of the sorted ids.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import matmul, storage_dtype


class Side:
    """One side's ratings as CSR on the device: row ``r``'s entries are
    ``cols[indptr[r]:indptr[r + 1]]`` with ``vals`` alike."""

    def __init__(self, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 n_rows: int, device):
        order = np.lexsort((cols, rows))
        counts = np.bincount(rows, minlength=n_rows)
        indptr = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        self.n_rows = n_rows
        self.indptr = torch.from_numpy(indptr).to(device)
        self.degree = torch.from_numpy(counts).to(device)
        self.cols = torch.from_numpy(cols[order]).to(device)
        self.vals = torch.from_numpy(vals[order]).to(device)


class Problem:
    """The ratings indexed as the reference indexes them."""

    def __init__(self, users, items, values, device):
        uniq_u, rows = np.unique(users, return_inverse=True)
        uniq_i, cols = np.unique(items, return_inverse=True)
        self.n_users, self.n_items = len(uniq_u), len(uniq_i)
        self.user_side = Side(rows, cols, values, self.n_users, device)
        self.item_side = Side(cols, rows, values, self.n_items, device)
        self.device = torch.device(device)


def initial_items(n_items: int, k: int, seed: int, bound: float
                  ) -> np.ndarray:
    """qmf's uniform(-bound, bound) start of the item factors, drawn from
    ``np.random.default_rng(seed)``, in the float32 the configuration
    stores."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-bound, bound, size=(n_items, k)).astype(np.float32)


def bucket_widths(deg: torch.Tensor) -> torch.Tensor:
    """Each row's bucket: the least power of two at or above its degree.
    Rounded to the nearest integer before the cast, and never below the
    degree, because a floating power of two may come out a hair below the
    integer (2**11 as 2047.99... on a CUDA device), which truncates to a
    bucket one lane short."""
    exp = torch.ceil(torch.log2(deg.clamp(min=1).to(torch.float64)))
    return torch.maximum(torch.exp2(exp).round().to(torch.int64), deg)


def solve_side(fixed: torch.Tensor, side: Side, alpha: float, lam: float,
               precision: str, chunk_entries: int = 1 << 22,
               drop_half: bool = False):
    """(the side's new factors (n_rows, k), its summed loss).
    ``drop_half`` plants a fault for the harness's calibration: each chunk
    solves its first half of rows and leaves the rest at zero."""
    dtype = storage_dtype(precision)
    fixed = fixed.to(dtype)
    dev, k = fixed.device, fixed.shape[1]
    gram = matmul(fixed.T, fixed, precision).to(dtype)
    base = gram + lam * torch.eye(k, dtype=dtype, device=dev)
    out = torch.zeros((side.n_rows, k), dtype=dtype, device=dev)
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    deg = side.degree
    width = bucket_widths(deg)
    last = max(side.cols.shape[0] - 1, 0)
    for w in torch.unique(width[deg > 0]).tolist():
        rows = torch.nonzero((width == w) & (deg > 0)).squeeze(1)
        step = max(1, chunk_entries // w)
        for s in range(0, rows.shape[0], step):
            r = rows[s:s + step]
            if drop_half:
                r = r[:(r.shape[0] + 1) // 2]
            lane = torch.arange(w, device=dev)
            mask = lane[None, :] < deg[r][:, None]
            pos = (side.indptr[r][:, None] + lane[None, :]).clamp(max=last)
            y = fixed[side.cols[pos]]  # (B, w, k)
            v = torch.where(mask, side.vals[pos], 0.0).to(dtype)
            wgt = alpha * v
            conf = mask.to(dtype) + wgt
            a = base + matmul((y * wgt[..., None]).transpose(1, 2), y,
                              precision).to(dtype)
            b = matmul(conf[:, None, :], y, precision).squeeze(1).to(dtype)
            chol, _ = torch.linalg.cholesky_ex(a)
            x = torch.cholesky_solve(b[..., None], chol).squeeze(-1)
            out[r] = x
            loss += (conf.sum(1) - (x * b).sum(1)
                     - lam * (x * x).sum(1)).to(torch.float64).sum()
    return out, loss


def epochs(problem: Problem, item_factors, n_epochs: int, alpha: float,
           lam: float, precision: str = "float64", drop_half: bool = False):
    """``n_epochs`` epochs from ``item_factors``: (user factors, item
    factors, the per-epoch losses as floats); ``drop_half`` as in
    ``solve_side``."""
    v = torch.as_tensor(item_factors).to(problem.device,
                                         storage_dtype(precision))
    losses = []
    u = None
    for _ in range(n_epochs):
        u, _ = solve_side(v, problem.user_side, alpha, lam, precision,
                          drop_half=drop_half)
        v, loss = solve_side(u, problem.item_side, alpha, lam, precision,
                             drop_half=drop_half)
        losses.append(float(loss) / problem.n_users / problem.n_items)
    return u, v, losses
