"""Sharded WALS: each rank builds and solves its rows of every width class.

The port of qmf_tpu/parallel/sharded_wals.py. There, bucket arrays are
row-sharded over the mesh (``P(axis)``), ``shard_map`` runs the Pallas
stages on each device's shard, and the solved rows stay row-sharded. Here:

- every width class is split into contiguous row blocks, rank r holding
  rows [r n/W, (r+1) n/W) of its col_idx, values, mask and hot weights
  (:class:`ShardedBuckets`); the classes are padded to multiples of 8 W
  rows (the engine's ``_row_multiple``), so the blocks are even, and each
  rank scans its block in chunks of chunk_b / W rows;
- per class, the rank's solved rows go to every rank by one all_gather and
  are scattered through the class's full row_ids (ops/als_ops.py
  ``_solve_side`` with ``mesh``). Factors stay replicated between
  half-epochs: a row-sharded store would need an all-to-all per class, since
  a block's rows scatter to arbitrary factor rows; the replicated one moves
  the same bytes, one factor matrix per rank per half-epoch, with one kind
  of collective. With the fixed side whole on every rank, each rank forms
  YtY whole from its real rows, as one device does, rather than through
  :func:`sharded_gramian` (qmf_tpu's psum over row blocks, kept for a
  row-sharded store): at world size 1 the factors are the single-device
  engine's bit for bit.

Padding rows of a class carry the id of the sink row, one past the padded
factor height, and never a row that enters the Gramian.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from qmf_tpu_torch.ops import als_ops
from qmf_tpu_torch.parallel.mesh import Mesh


def sharded_gramian(y_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """YtY of a matrix whose rows are split among the ranks, from this
    rank's block: the local k x k product summed by one all_reduce. Zero
    padding rows add nothing."""
    return mesh.all_reduce_sum(y_local.T @ y_local)


def pad_rows(n: int, mesh: Mesh) -> int:
    """Smallest height >= n that the world size divides."""
    return n + ((-n) % mesh.size)


class ShardedBuckets:
    """Width classes with this rank's contiguous block of rows.

    ``row_ids`` are each class's full row ids (every rank scatters the whole
    class), the padding rows' id (``n_rows``, the packer's) moved to the
    sink row ``pad_rows(n_rows, mesh)``; ``col_idx``, ``values`` and ``mask``
    hold this rank's block only.
    """

    def __init__(self, buckets, mesh: Mesh, dtype: torch.dtype, n_rows: int):
        dev = mesh.device
        sink = pad_rows(n_rows, mesh)
        self.row_ids, self.col_idx, self.values, self.mask = [], [], [], []
        # a bucket's arrays are numpy (the host pack, cut here before the
        # copy) or tensors on the device (the device pack, world 1)
        for b in buckets:
            lo, hi = mesh.block_bounds(b.row_ids.shape[0])
            rows = torch.as_tensor(b.row_ids).to(dev, torch.int64)
            self.row_ids.append(torch.where(rows >= n_rows, sink, rows))
            self.col_idx.append(torch.as_tensor(b.col_idx[lo:hi]).to(
                dev, torch.int64))
            self.values.append(torch.as_tensor(b.values[lo:hi]).to(
                dev, dtype))
            self.mask.append(torch.as_tensor(b.mask[lo:hi]).to(dev))

    def arrays(self) -> List[Tuple[torch.Tensor, ...]]:
        return list(zip(self.row_ids, self.col_idx, self.values, self.mask))

    def __len__(self) -> int:
        return len(self.row_ids)


def shard_hot(hot, mesh: Mesh):
    """One side's hot state with each class's (w_a, w_b, conf) cut to this
    rank's block, as its class is; the hot ids stay whole (every rank's
    build reads the same fixed-side head)."""
    if hot is None:
        return None
    hot_ids, classes = hot
    return hot_ids, [tuple(mesh.block(t).clone() for t in cls)
                     for cls in classes]


def iterate_side_sharded(y: torch.Tensor, buckets: ShardedBuckets,
                         chunk_sizes, n_rows: int, alpha: float, lam: float,
                         mesh: Mesh, solver: str = "cholesky",
                         precision: str = "highest", hot=None,
                         n_fixed=None, class_solve: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sharded half-epoch against the whole fixed side ``y`` (its rows
    from ``n_fixed`` on zero padding): the new factors of the ``n_rows``
    rows, padded to ``pad_rows(n_rows, mesh)``, on every rank, and the
    summed loss. ``chunk_sizes`` are this rank's chunks; with
    ``class_solve=False`` the rank solves each of them as it builds it, into
    its block of the class, before the class's one all_gather."""
    return als_ops._solve_side(y, buckets.arrays(), chunk_sizes, n_rows,
                               alpha, lam, solver, precision, hot, mesh,
                               n_fixed, class_solve)
