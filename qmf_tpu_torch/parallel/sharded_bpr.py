"""Data-parallel BPR over the ranks of a process group (port of
qmf_tpu/parallel/sharded_bpr.py).

qmf_tpu shards each minibatch over the mesh, keeps the parameters
replicated, and lets GSPMD merge the scatter-adds across chips. Here each
rank runs one ``ShardedBPREngine``:

- the parameters are replicated, and every rank draws what the
  single-device engine draws (the same ``draw_*`` calls on a generator
  seeded alike);
- every rank presamples the whole epoch (the grouped presample compacts
  its collisions over the whole stream, so a slice of it cannot be
  computed alone), then computes the gradients of its contiguous lanes of
  each step only;
- before the step's first scatter, one all_gather per dtype gives every
  rank the whole step's ids and gradient rows (ops/bpr_ops.py
  ``_whole_batch``), and every rank applies them in the single-device
  order. The parameters stay equal on every rank; in float64 on the CPU
  they equal the single-device engine's.

The grouped path needs ``_grp_batch`` divisible by the world size, or the
engine takes the legacy triplet stream, which is padded with zero-weight
rows to a multiple of batch_size x world size, as qmf_tpu pads it. Only
rank 0 evaluates, logs and writes checkpoints and factor files; every rank
resumes from the same file, onto its own device.
"""

from __future__ import annotations

from typing import Optional

import torch

from qmf_tpu_torch.config import BPRConfig
from qmf_tpu_torch.models.bpr import BPREngine
from qmf_tpu_torch.parallel.mesh import Mesh, make_mesh


class ShardedBPREngine(BPREngine):
    def __init__(
        self,
        config: BPRConfig,
        metrics_engine=None,
        eval_num_neg: int = 3,
        eval_seed: int = 42,
        mesh: Optional[Mesh] = None,
        n_devices: Optional[int] = None,
        device: Optional[str | torch.device] = None,
    ):
        self.mesh = mesh if mesh is not None else make_mesh(
            n_devices, device=device)
        super().__init__(config, metrics_engine, eval_num_neg, eval_seed,
                         device=self.mesh.device)

    def init(self, dataset) -> None:
        super().init(dataset)
        w = self.mesh.size
        if self._grouped and self._grp_batch % w != 0:
            # a step must split evenly over the ranks: small batches take
            # the legacy stream
            self._build_triplet_stream()
        if not self._grouped:
            extra = (-self._tri_users.shape[0]) % (self.config.batch_size * w)
            if extra:
                self._tri_users = torch.cat(
                    [self._tri_users, self._tri_users.new_zeros(extra)])
                self._tri_items = torch.cat(
                    [self._tri_items, self._tri_items.new_zeros(extra)])
                self._tri_weights = torch.cat(
                    [self._tri_weights, self._tri_weights.new_zeros(extra)])

    def evaluate(self, epoch: int, elapsed: float = 0.0) -> None:
        if self.mesh.rank == 0:
            super().evaluate(epoch, elapsed)
        else:
            self._last_overflow = None

    def _maybe_checkpoint(self, epoch: int) -> None:
        if self.mesh.rank == 0:
            super()._maybe_checkpoint(epoch)

    def save_user_factors(self, file_name: str) -> None:
        if self.mesh.rank == 0:
            super().save_user_factors(file_name)

    def save_item_factors(self, file_name: str) -> None:
        if self.mesh.rank == 0:
            super().save_item_factors(file_name)
