"""WALS training engine in PyTorch (port of qmf_tpu/models/wals.py).

- ``init``: builds sorted-id indices and width-class padded arrays for both
  sides on the host (reference WALSEngine.cpp:37-69 + 130-163), moves them to
  ``device`` once, and initializes item factors uniform(+-bound) from
  ``np.random.default_rng(init_seed)`` or from a distribution file, so a seed
  gives the same start as qmf_tpu. User factors start at zero.
- ``optimize``: per epoch, solve users given items, then items given users;
  the logged train loss comes from the item half-epoch, normalized by
  nusers*nitems (reference WALSEngine.cpp:82-96).
- Each half-epoch is ops/als_ops.py ``_solve_side``: per width class a
  chunked build and one batched SPD solve, which on a CUDA device is the
  hand-written kernel (solver "kernel").
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from qmf_tpu.data.dataset import Dataset
from qmf_tpu.data.factor_io import FactorData
from qmf_tpu.data.id_index import IdIndex
from qmf_tpu.utils import checkpoint as ckpt
from qmf_tpu.utils.logging import log
from qmf_tpu_torch import kernels
from qmf_tpu_torch.config import WALSConfig
from qmf_tpu_torch.models.engine import Engine
from qmf_tpu_torch.ops import als_ops
from qmf_tpu_torch.ops.packing import (
    chunks_for_classes,
    pack_width_classes,
    packed_stats,
)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}

# One width class on the device: (row_ids, col_idx, values, mask).
ClassArrays = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class WALSEngine(Engine):
    def __init__(
        self,
        config: WALSConfig,
        metrics_engine=None,
        device: str | torch.device = "cuda",
    ):
        self.config = config
        self.metrics_engine = metrics_engine
        self.device = torch.device(device)
        self.dtype = _DTYPES[config.dtype]
        # "highest" must be true fp32 on Hopper: set it here rather than
        # inherit process state (cuDNN defaults to TF32, and any caller may
        # have turned matmul TF32 on)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.user_index: Optional[IdIndex] = None
        self.item_index: Optional[IdIndex] = None
        self.user_factors: Optional[torch.Tensor] = None  # (U, k)
        self.item_factors: Optional[torch.Tensor] = None  # (I, k)
        self._user_classes: List[ClassArrays] = []
        self._item_classes: List[ClassArrays] = []
        self._user_chunks: List[int] = []
        self._item_chunks: List[int] = []
        self._solver: Optional[str] = None
        self._ckpt_dir: Optional[str] = None
        self._ckpt_every = 1
        self.test_users: Optional[np.ndarray] = None
        self.test_labels: Optional[np.ndarray] = None
        # optional per-epoch progress hook: fn(epoch, loss, wall_s)
        self.progress_cb = None
        if (
            metrics_engine is not None
            and metrics_engine.test_avg_metrics
            and metrics_engine.config.num_test_users == 0
        ):
            log.warning(
                "computing average test metrics on all users can be slow! "
                "Set num_test_users > 0 to sample some of them"
            )

    @property
    def nusers(self) -> int:
        return self.user_index.size if self.user_index else 0

    @property
    def nitems(self) -> int:
        return self.item_index.size if self.item_index else 0

    def _auto_solver(self) -> str:
        """Resolve solver="auto": the hand-written CUDA kernel on a CUDA
        device when k fits its shared memory, plain cholesky otherwise."""
        if (
            self.device.type == "cuda"
            and self.config.nfactors <= kernels.chol_solve_max_k(self.dtype)
        ):
            return "kernel"
        return "cholesky"

    # --- lifecycle -----------------------------------------------------------
    def _to_device(self, classes) -> List[ClassArrays]:
        dev = self.device
        return [
            (torch.from_numpy(c.row_ids.astype(np.int64)).to(dev),
             torch.from_numpy(c.col_idx.astype(np.int64)).to(dev),
             torch.from_numpy(c.values).to(dev, self.dtype),
             torch.from_numpy(c.mask).to(dev))
            for c in classes
        ]

    def init(self, dataset: Dataset) -> None:
        if self.user_factors is not None or self.item_factors is not None:
            raise RuntimeError("engine was already initialized with train data")
        cfg = self.config
        self._solver = (
            self._auto_solver() if cfg.solver == "auto" else cfg.solver
        )
        log.info("WALS solver %s on %s (%s)", self._solver, self.device,
                 cfg.dtype)
        self.user_index, rows = IdIndex.from_sorted_ids_with_lookup(
            dataset.user_ids
        )
        self.item_index, cols = IdIndex.from_sorted_ids_with_lookup(
            dataset.item_ids
        )

        t0 = time.time()
        sides = {}
        for side, r, c, n in (("user", rows, cols, self.nusers),
                              ("item", cols, rows, self.nitems)):
            classes = pack_width_classes(
                r, c, dataset.values, n, cfg.batch_rows, row_multiple=8,
                width_grid=cfg.width_grid, max_classes=cfg.max_width_classes,
                min_class_nnz_frac=cfg.min_class_nnz_frac,
            )
            sides[side] = packed_stats(classes)
            setattr(self, f"_{side}_chunks",
                    chunks_for_classes(classes, cfg.batch_rows,
                                       row_multiple=8))
            setattr(self, f"_{side}_classes", self._to_device(classes))
        log.info(
            "packed %d ratings: users %s, items %s hot=(0,0) (%.2fs)",
            len(dataset), sides["user"], sides["item"], time.time() - t0,
        )

        # item factors init: uniform or deterministic file; user factors zero
        # (overwritten in the first user half-epoch) — WALSEngine.cpp:55-68.
        item_init = FactorData(self.nitems, cfg.nfactors)
        if cfg.distribution_file:
            item_init.set_factors_from_file(cfg.distribution_file)
        else:
            item_init.set_factors_uniform(
                cfg.init_distribution_bound,
                np.random.default_rng(cfg.init_seed),
            )
        self.item_factors = torch.as_tensor(
            item_init.factors, dtype=self.dtype, device=self.device
        )
        self.user_factors = torch.zeros(
            (self.nusers, cfg.nfactors), dtype=self.dtype, device=self.device
        )

    def load_factors(self, user_factors: torch.Tensor,
                     item_factors: torch.Tensor) -> None:
        """Replace the factors of an initialized engine (e.g. with a JAX
        engine's, through convert.factors_from_jax); shapes must match."""
        for name, t, n in (("user", user_factors, self.nusers),
                           ("item", item_factors, self.nitems)):
            if tuple(t.shape) != (n, self.config.nfactors):
                raise ValueError(
                    f"{name} factors {tuple(t.shape)} != "
                    f"({n}, {self.config.nfactors})"
                )
        self.user_factors = user_factors.to(self.device, self.dtype)
        self.item_factors = item_factors.to(self.device, self.dtype)

    def init_test(self, test_dataset: Dataset) -> None:
        if self.test_users is not None:
            raise RuntimeError("engine was already initialized with test data")
        if self.metrics_engine is not None and self.metrics_engine.test_avg_metrics:
            self.test_users, self.test_labels = self.init_avg_test_data(
                test_dataset,
                self.user_index,
                self.item_index,
                self.metrics_engine.config.num_test_users,
                self.metrics_engine.config.seed,
            )

    def _epoch(self) -> float:
        """One full epoch (als_ops.train_epoch); returns the reference-
        normalized item-side train loss."""
        cfg = self.config
        self.user_factors, self.item_factors, _, loss = als_ops.train_epoch(
            self.user_factors, self.item_factors, self._user_classes,
            self._item_classes, cfg.confidence_weight,
            cfg.regularization_lambda, self._solver, cfg.matmul_precision,
            self.nusers, self.nitems, self._user_chunks, self._item_chunks,
        )
        return float(loss) / self.nusers / self.nitems

    def enable_checkpointing(self, directory: str, every: int = 1) -> None:
        """Per-epoch checkpoint + auto-resume through the shared
        qmf_tpu.utils.checkpoint (a qmf_tpu checkpoint resumes here too)."""
        self._ckpt_dir = directory
        self._ckpt_every = max(1, every)

    def _maybe_resume(self) -> int:
        """Returns the first epoch to run (1 if no checkpoint)."""
        if not self._ckpt_dir:
            return 1
        path = ckpt.latest_checkpoint(self._ckpt_dir)
        if path is None:
            return 1
        epoch, arrays, _ = ckpt.load_checkpoint(path)
        self.load_factors(torch.from_numpy(arrays["user_factors"]),
                          torch.from_numpy(arrays["item_factors"]))
        log.info("resumed from %s at epoch %d", path, epoch)
        return epoch + 1

    def _maybe_checkpoint(self, epoch: int) -> None:
        if self._ckpt_dir and epoch % self._ckpt_every == 0:
            ckpt.save_checkpoint(
                self._ckpt_dir,
                epoch,
                {
                    "user_factors": self.user_factors.cpu().numpy(),
                    "item_factors": self.item_factors.cpu().numpy(),
                },
                meta={"nfactors": self.config.nfactors, "engine": "wals"},
            )

    @staticmethod
    def _check_finite(loss: float, epoch: int) -> None:
        """Divergence guard (the WALS analog of the reference BPR's
        CHECK(isfinite), qmf/bpr/BPREngine.cpp:184-185).

        The f32/bf16 path can lose positive-definiteness of the normal
        equations on pathologically conditioned inputs (e.g. massive
        duplicate user-item multiplicity); the kernel then yields NaN rows.
        Fail loudly with the remediation options instead of silently saving
        NaN factors.
        """
        if not np.isfinite(loss):
            raise FloatingPointError(
                f"non-finite WALS training loss at epoch {epoch}: the "
                "f32/bf16 path lost positive-definiteness of the normal "
                "equations (extreme conditioning, e.g. massive duplicate "
                "user-item multiplicity). Retry with "
                "--matmul_precision=highest, --solver=lu (the dsysv_-"
                "faithful indefinite solver), or --dtype=float64."
            )

    def optimize(self) -> None:
        if self.user_factors is None or self.item_factors is None:
            raise RuntimeError(
                "no factor data, have you initialized the engine?"
            )
        for epoch in range(self._maybe_resume(), self.config.nepochs + 1):
            t0 = time.time()
            loss = self._epoch()  # float() waits for the device
            dt = time.time() - t0
            log.info(
                "epoch %d: train loss = %.10g (%.3fs)", epoch, loss, dt
            )
            self._check_finite(loss, epoch)
            if self.progress_cb is not None:
                self.progress_cb(epoch, loss, dt)
            self.evaluate(epoch)
            self._maybe_checkpoint(epoch)

    def evaluate(self, epoch: int) -> None:
        me = self.metrics_engine
        if (
            me is not None
            and me.test_avg_metrics
            and self.test_users is not None
            and len(self.test_users)
            and (me.config.always_compute or epoch == self.config.nepochs)
        ):
            log.info("do compute evaluate ...")
            scores = als_ops.compute_scores(
                self.user_factors,
                self.item_factors,
                user_idx=torch.from_numpy(self.test_users).to(self.device),
            )
            me.compute_and_record_test_avg_metrics(
                epoch, self.test_labels, scores
            )

    # --- output --------------------------------------------------------------
    def save_user_factors(self, file_name: str) -> None:
        if self.user_factors is None:
            raise RuntimeError("user factors wasn't initialized")
        self.save_factor_data(
            self.user_factors.cpu().numpy().astype(np.float64),
            self.user_index,
            file_name,
        )

    def save_item_factors(self, file_name: str) -> None:
        if self.item_factors is None:
            raise RuntimeError("item factors wasn't initialized")
        self.save_factor_data(
            self.item_factors.cpu().numpy().astype(np.float64),
            self.item_index,
            file_name,
        )
