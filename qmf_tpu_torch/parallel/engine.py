"""ShardedWALSEngine: WALSEngine with each half-epoch's rows shared out
among the ranks of a process group (port of qmf_tpu/parallel/engine.py).

Run one per rank. ``init`` is WALSEngine's: its three placement hooks keep
this rank's block of every class (parallel/sharded_wals.py) and pad the
factor heights to a multiple of the world size. Each epoch is
``als_ops.train_epoch`` with the mesh: the rank builds and solves its rows
(the CUDA kernels on a card, as the single-device engine's "auto" picks
them) and the solved rows are exchanged by one all_gather per class. The
factors end each half-epoch equal on every rank. In float64 the results
are the single-device engine's to rounding.

``fuse_epoch`` takes WALSEngine's routes (qmf_tpu/parallel/engine.py:169-199:
the whole run as one program, or one program an epoch), the collectives
inside the program. Over NCCL on a card the program is a CUDA graph; over
gloo it runs as eager ops, since a graph cannot hold gloo's host-side
collectives (ops/graphs.py ``eager_reasons``: decided before the first
epoch and logged).

Checkpoints hold the unpadded factors, so a run resumes on any number of
ranks, a single-device engine's included, and the reverse. Only rank 0
writes checkpoints, evaluates and saves factor files; every rank resumes
from the same file.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from qmf_tpu_torch.config import WALSConfig
from qmf_tpu_torch.models.wals import WALSEngine
from qmf_tpu_torch.parallel.mesh import Mesh, make_mesh
from qmf_tpu_torch.parallel.sharded_wals import (
    ShardedBuckets,
    pad_rows,
    shard_hot,
)


class ShardedWALSEngine(WALSEngine):
    def __init__(
        self,
        config: WALSConfig,
        metrics_engine=None,
        mesh: Optional[Mesh] = None,
        n_devices: Optional[int] = None,
        device: Optional[str | torch.device] = None,
    ):
        self.mesh = mesh if mesh is not None else make_mesh(
            n_devices, device=device)
        super().__init__(config, metrics_engine, device=self.mesh.device)
        self._pad_users = self._pad_items = 0

    def _use_device_pack(self) -> bool:
        # each rank is a process with the whole COO on the host; packing on
        # the card at a world of several would need the COO laid out over
        # the ranks first, so such a run keeps the host pack, as qmf_tpu's
        # multi-process run does (qmf_tpu/parallel/engine.py:88-94)
        return self.mesh.size == 1 and super()._use_device_pack()

    # --- the placement hooks of WALSEngine.init -----------------------------
    def _row_multiple(self) -> int:
        # every class and scan chunk splits evenly into the ranks' blocks
        return 8 * self.mesh.size

    def _place_side(self, side: str, classes, hot, chunks) -> None:
        n = self.nusers if side == "user" else self.nitems
        buckets = ShardedBuckets(classes, self.mesh, self.dtype, n)
        setattr(self, f"_{side}_classes", buckets.arrays())
        # each rank scans its share of every chunk, as the sharded scan does
        setattr(self, f"_{side}_chunks", [c // self.mesh.size for c in chunks])
        setattr(self, f"_{side}_hot", shard_hot(hot, self.mesh))

    def _padded(self, t: torch.Tensor, height: int) -> torch.Tensor:
        out = torch.zeros((height, self.config.nfactors), dtype=self.dtype,
                          device=self.device)
        out[: t.shape[0]] = t
        return out

    def _install_factors(self, item_factors_np: np.ndarray) -> None:
        self._pad_users = pad_rows(self.nusers, self.mesh)
        self._pad_items = pad_rows(self.nitems, self.mesh)
        super()._install_factors(item_factors_np)
        self.user_factors = self._padded(self.user_factors, self._pad_users)
        self.item_factors = self._padded(self.item_factors, self._pad_items)

    def load_factors(self, user_factors: torch.Tensor,
                     item_factors: torch.Tensor) -> None:
        """Replace the factors with full unpadded matrices (e.g. a JAX
        engine's, through convert.factors_from_jax), padded here."""
        super().load_factors(user_factors, item_factors)
        self.user_factors = self._padded(self.user_factors, self._pad_users)
        self.item_factors = self._padded(self.item_factors, self._pad_items)

    # --- rank 0 alone ------------------------------------------------------
    def _maybe_checkpoint(self, epoch: int) -> None:
        if self.mesh.rank == 0:
            super()._maybe_checkpoint(epoch)

    def evaluate(self, epoch: int) -> None:
        if self.mesh.rank == 0:
            super().evaluate(epoch)

    def save_user_factors(self, file_name: str) -> None:
        if self.mesh.rank == 0:
            super().save_user_factors(file_name)

    def save_item_factors(self, file_name: str) -> None:
        if self.mesh.rank == 0:
            super().save_item_factors(file_name)
