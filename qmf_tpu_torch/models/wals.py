"""WALS training engine in PyTorch (port of qmf_tpu/models/wals.py).

- ``init``: builds sorted-id indices on the host, then the width-class
  padded arrays of both sides (reference WALSEngine.cpp:37-69 + 130-163):
  with ``device_pack`` (float32 on a CUDA device by default) the COO goes to
  the card once and is sorted and gathered there (ops/device_pack.py),
  otherwise it is packed on the host (ops/packing.py) and the classes are
  copied. Item factors start uniform(+-bound) from
  ``np.random.default_rng(init_seed)`` or from a distribution file, so a seed
  gives the same start as qmf_tpu; user factors at zero. ``_init_stages``
  holds the seconds of each stage (index, pack_user, pack_item, copy,
  factors), each stage that touches the card ending in a synchronize.
- ``optimize``: per epoch, solve users given items, then items given users;
  the logged train loss comes from the item half-epoch, normalized by
  nusers*nitems (reference WALSEngine.cpp:82-96). With ``fuse_epoch`` (the
  default) it takes qmf_tpu's routes (models/wals.py:413-502, 581-626): the
  whole run as one program when no epoch needs the host in between
  (``_can_fuse_run``: no checkpoints, no always-compute metrics), else one
  program an epoch. On a CUDA device that program is the epoch captured as
  a CUDA graph at the first epoch and replayed (ops/graphs.py), unless
  ``graphs.eager_reasons`` names a reason to run it eagerly; the decision
  is made once and logged. ``fuse_epoch=False`` dispatches each epoch
  eagerly.
- Each half-epoch is ops/als_ops.py ``_solve_side``: per width class a
  chunked build and one batched SPD solve, which on a CUDA device is the
  hand-written kernel (solver "kernel"); or, with solver "fused", one
  build+solve kernel launch per chunk.
- ``hot_width`` > 0 splits each side's H hottest fixed-side columns out of
  the gathered stream into static per-row weights (ops/hot.py), built once
  here; "auto" resolves to 0 in the port.
- ``init``'s placement hooks (``_row_multiple``, ``_place_side``,
  ``_install_factors``) and the checkpoint pair (``_checkpoint_arrays``,
  ``_restore_factors``) are what parallel/engine.py's ShardedWALSEngine
  overrides.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from qmf_tpu_torch import kernels
from qmf_tpu_torch.config import WALSConfig
from qmf_tpu_torch.data.dataset import Dataset
from qmf_tpu_torch.data.factor_io import FactorData
from qmf_tpu_torch.data.id_index import IdIndex
from qmf_tpu_torch.models.engine import Engine
from qmf_tpu_torch.ops import als_ops, device_pack, graphs
from qmf_tpu_torch.ops import hot as hot_ops
from qmf_tpu_torch.ops.packing import (
    chunks_for_classes,
    pack_width_classes,
    packed_stats,
)
from qmf_tpu_torch.utils import checkpoint as ckpt
from qmf_tpu_torch.utils.logging import log
from qmf_tpu_torch.utils.tracing import annotate

_DTYPES = {"float32": torch.float32, "float64": torch.float64}

# One width class on the device: (row_ids, col_idx, values, mask).
ClassArrays = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# One side's hot state: (hot column ids, per-class (w_a, w_b, conf_hot)).
HotState = Tuple[torch.Tensor, List[Tuple[torch.Tensor, ...]]]


class WALSEngine(Engine):
    # the ranks' Mesh of the sharded engine (parallel/engine.py); None
    # solves every row here
    mesh = None

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
        self._user_hot: Optional[HotState] = None
        self._item_hot: Optional[HotState] = None
        self._solver: Optional[str] = None
        self._init_stages: dict = {}  # stage -> seconds (observability)
        self._pack_kind: Optional[str] = None  # "device-packed" / "host-packed"
        self._ckpt_dir: Optional[str] = None
        self._ckpt_every = 1
        # the epoch as a function of the item factors (als_ops.epoch_body),
        # made at its first use; and the epoch as one program (fuse_epoch):
        # that function or a graphs.EpochGraph of it, with the reasons it
        # runs eagerly
        self._body = None
        self._program = None
        self._eager_reasons: List[str] = []
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

    def _use_device_pack(self) -> bool:
        """Resolve device_pack="auto" as qmf_tpu does
        (qmf_tpu/models/wals.py:110-119): on for float32 on a CUDA device,
        off on the CPU (nothing to copy) and for float64."""
        dp = self.config.device_pack
        if dp == "auto":
            return self.dtype == torch.float32 and self.device.type == "cuda"
        return dp

    def _resolve_hot_width(self) -> int:
        """The hot_width knob for one side's build (0 = no split). "auto"
        is 0 in the port: qmf_tpu's cost model (ops/hot.py) was fitted on
        a TPU, and no H100 measurement shows yet that the split pays."""
        hw = self.config.hot_width
        return 0 if hw == "auto" else int(hw)

    def _hot_store_dtype(self) -> torch.dtype:
        """Storage dtype of the static hot weights W_a/W_b: bf16 when the
        build runs on bf16 operands anyway, else the engine dtype."""
        if (self.dtype == torch.float32
                and self.config.matmul_precision == "default"):
            return torch.bfloat16
        return self.dtype

    def _pack_kw(self) -> dict:
        cfg = self.config
        return dict(row_multiple=self._row_multiple(),
                    width_grid=cfg.width_grid,
                    max_classes=cfg.max_width_classes,
                    min_class_nnz_frac=cfg.min_class_nnz_frac)

    def _hot_state(self, hot_ids, hot_rows, hot_ranks, hot_vals, row_ids,
                   n_rows):
        """The hot state of one side: its hot column ids on the device and
        each class's (W_a, W_b, conf_hot) in packed order."""
        return torch.from_numpy(hot_ids.astype(np.int64)).to(self.device), \
            hot_ops.build_hot_classes(
                hot_rows, hot_ranks, hot_vals, row_ids, n_rows, len(hot_ids),
                self.config.confidence_weight, self.dtype,
                self._hot_store_dtype(), self.device)

    def _pack_side_host(self, rows, cols, vals, n_rows, n_cols, deg_rows,
                        deg_cols, h):
        """Host-pack one side, hot/cold split when ``h`` > 0 (qmf_tpu
        models/wals.py:193-227). Returns (classes, chunks, stats, hot state
        or None); the classes are numpy Buckets."""
        cfg = self.config
        kw = self._pack_kw()
        hot = None
        if h <= 0:
            classes = pack_width_classes(rows, cols, vals, n_rows,
                                         cfg.batch_rows, **kw)
        else:
            hot_ids = hot_ops.top_hot_columns(deg_cols, h)
            col_rank = hot_ops.rank_lookup(hot_ids, n_cols)
            is_hot = col_rank[cols] < len(hot_ids)
            # rows whose entries are all hot keep a fully masked slot
            classes = pack_width_classes(
                rows[~is_hot], cols[~is_hot], vals[~is_hot], n_rows,
                cfg.batch_rows, active_mask=deg_rows > 0, **kw,
            )
            hot = self._hot_state(
                hot_ids, rows[is_hot], col_rank[cols[is_hot]], vals[is_hot],
                [c.row_ids for c in classes], n_rows)
        chunks = chunks_for_classes(classes, cfg.batch_rows,
                                    row_multiple=kw["row_multiple"])
        return classes, chunks, packed_stats(classes), hot

    def _pack_side_device(self, coo, rows, cols, n_rows, n_cols, deg_rows,
                          deg_cols, h):
        """Device-pack one side (qmf_tpu models/wals.py:146-191): ``coo``
        is the (rows, cols, vals) triple on the device, ``rows`` and
        ``cols`` the same indices on the host, which give the degrees and
        the hot split's counts. Returns (classes, chunks, stats, hot state
        or None); the classes are Buckets of device tensors."""
        cfg = self.config
        kw = self._pack_kw()
        r_d, c_d, v_d = coo
        hot = None
        if h <= 0:
            nnz = len(rows)
            classes, plans = device_pack.pack_width_classes_device(
                r_d, c_d, v_d, n_rows, deg_rows, cfg.batch_rows, **kw)
        else:
            hot_ids = hot_ops.top_hot_columns(deg_cols, h)
            col_rank = hot_ops.rank_lookup(hot_ids, n_cols)
            is_hot = col_rank[cols] < len(hot_ids)
            nnz = int(len(is_hot) - is_hot.sum())  # the cold entries
            rank_d = torch.from_numpy(col_rank.astype(np.int64)).to(
                self.device)
            presorted, (hot_r, hot_c, hot_v) = device_pack.split_sorted_csr(
                r_d, c_d, v_d, rank_d[c_d] < len(hot_ids), n_rows, nnz)
            classes, plans = device_pack.pack_width_classes_device(
                r_d, c_d, v_d, n_rows,
                np.bincount(rows[~is_hot], minlength=n_rows),
                cfg.batch_rows, active_mask=deg_rows > 0,
                presorted=presorted, **kw)
            hot = self._hot_state(hot_ids, hot_r, rank_d[hot_c], hot_v,
                                  [p.row_ids for p in plans], n_rows)
        return classes, [p.chunk_b for p in plans], device_pack.plan_stats(
            plans, nnz), hot

    # --- lifecycle -----------------------------------------------------------
    # init is shared with ShardedWALSEngine (parallel/engine.py) through
    # three placement hooks, _row_multiple, _place_side and
    # _install_factors, as in qmf_tpu (models/wals.py:231-260), so the
    # pack, stats and chunk logic exists once.
    def _row_multiple(self) -> int:
        """Row-count multiple every class and scan chunk is padded to (the
        sharded engine raises it to 8 x world size, so blocks are even)."""
        return 8

    def _to_device(self, classes) -> List[ClassArrays]:
        """The classes' arrays on the device, as the build reads them (the
        device pack's are there already)."""
        dev = self.device
        return [
            (torch.as_tensor(c.row_ids).to(dev, torch.int64),
             torch.as_tensor(c.col_idx).to(dev, torch.int64),
             torch.as_tensor(c.values).to(dev, self.dtype),
             torch.as_tensor(c.mask).to(dev))
            for c in classes
        ]

    def _place_side(self, side: str, classes, hot, chunks) -> None:
        """Install one packed side: ``classes`` are the width classes
        (Buckets of numpy arrays from the host pack, of device tensors from
        the device pack), ``hot`` the optional hot state, ``chunks`` each
        class's scan chunk. The sharded engine keeps its rank's rows
        only."""
        setattr(self, f"_{side}_classes", self._to_device(classes))
        setattr(self, f"_{side}_chunks", chunks)
        setattr(self, f"_{side}_hot", hot)

    def _install_factors(self, item_factors_np: np.ndarray) -> None:
        """Place the initial factors: items from ``item_factors_np``,
        users zero (the sharded engine pads both heights)."""
        self.item_factors = torch.as_tensor(
            item_factors_np, dtype=self.dtype, device=self.device
        )
        self.user_factors = torch.zeros(
            (self.nusers, self.config.nfactors), dtype=self.dtype,
            device=self.device,
        )

    def _stage(self, name: str, t0: float) -> float:
        """Add the seconds since ``t0`` to stage ``name`` of
        ``_init_stages``, after the card's queued work; returns now. (No
        context yet means no queued work: the sync would only make one.)"""
        if self.device.type == "cuda" and torch.cuda.is_initialized():
            torch.cuda.synchronize(self.device)
        now = time.time()
        self._init_stages[name] = self._init_stages.get(name, 0.0) + now - t0
        return now

    def init(self, dataset: Dataset) -> None:
        if self.user_factors is not None or self.item_factors is not None:
            raise RuntimeError("engine was already initialized with train data")
        cfg = self.config
        self._solver = (
            self._auto_solver() if cfg.solver == "auto" else cfg.solver
        )
        log.info("WALS solver %s on %s (%s)", self._solver, self.device,
                 cfg.dtype)
        self._init_stages = {}
        t_init = t = time.time()
        self.user_index, rows = IdIndex.from_sorted_ids_with_lookup(
            dataset.user_ids
        )
        self.item_index, cols = IdIndex.from_sorted_ids_with_lookup(
            dataset.item_ids
        )
        deg_u = np.bincount(rows, minlength=self.nusers)
        deg_i = np.bincount(cols, minlength=self.nitems)
        t = self._stage("index", t)

        on_device = self._use_device_pack()
        if on_device:
            # the COO goes to the card once and serves both sides
            coo = [torch.from_numpy(a).to(self.device)
                   for a in (rows, cols, dataset.values)]
            coo[2] = coo[2].to(self.dtype)
            t = self._stage("copy", t)
        h_user = h_item = self._resolve_hot_width()
        sides = {}
        for side, r, c, n, n_cols, deg_r, deg_c, h in (
            ("user", rows, cols, self.nusers, self.nitems, deg_u, deg_i,
             h_user),
            ("item", cols, rows, self.nitems, self.nusers, deg_i, deg_u,
             h_item),
        ):
            if on_device:
                r_d, c_d = coo[:2] if side == "user" else coo[1::-1]
                classes, chunks, sides[side], hot = self._pack_side_device(
                    (r_d, c_d, coo[2]), r, c, n, n_cols, deg_r, deg_c, h)
            else:
                classes, chunks, sides[side], hot = self._pack_side_host(
                    r, c, dataset.values, n, n_cols, deg_r, deg_c, h)
            t = self._stage(f"pack_{side}", t)
            self._place_side(side, classes, hot, chunks)
            del classes
            t = self._stage("copy", t)
        if on_device:
            del coo
        kind = "device-packed" if on_device else "host-packed"
        log.info(
            "%s %d ratings: users %s, items %s hot=(%d,%d) (%.2fs)",
            kind, len(dataset), sides["user"], sides["item"], h_user, h_item,
            time.time() - t_init,
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
        self._install_factors(item_init.factors)
        self._stage("factors", t)
        self._pack_kind = kind
        log.info("WALS init stages (s): %s", {
            k: round(v, 3) for k, v in self._init_stages.items()})

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

    def _epoch_body(self):
        """The epoch on this engine's packed data as a function of the
        item factors (als_ops.epoch_body), made at its first use."""
        if self._body is None:
            cfg = self.config
            self._body = als_ops.epoch_body(
                self._user_classes, self._item_classes,
                cfg.confidence_weight, cfg.regularization_lambda,
                self._solver, cfg.matmul_precision, self.nusers, self.nitems,
                self._user_chunks, self._item_chunks, self._user_hot,
                self._item_hot, mesh=self.mesh,
            )
        return self._body

    def _epoch_program(self):
        """The epoch as one program, made at its first use: a CUDA graph
        of :meth:`_epoch_body` captured at its first call
        (graphs.EpochGraph) where nothing in ``graphs.eager_reasons`` stands
        against it (the device, the mesh's backend, the solver), else the
        body itself. Decided once an engine, and logged."""
        if self._program is None:
            self._program, self._eager_reasons = graphs.epoch_program(
                "WALS epoch program", self._epoch_body(), self.device,
                self.mesh, self._solver)
        return self._program

    def _own(self, u: torch.Tensor, v: torch.Tensor) -> None:
        """Install factors the epoch program returned: a graph's outputs
        are its static buffers, which the next replay overwrites, so they
        are copied out."""
        if isinstance(self._program, graphs.EpochGraph):
            u, v = u.clone(), v.clone()
        self.user_factors, self.item_factors = u, v

    def _fused_epoch(self) -> float:
        """One epoch as one program (qmf_tpu's _fused_epoch); returns the
        reference-normalized item-side train loss, its only host read."""
        u, v, loss = self._epoch_program()(self.item_factors)
        self._own(u, v)
        return float(loss) / self.nusers / self.nitems

    def _fused_run(self, nepochs: int) -> List[float]:
        """The remaining ``nepochs`` epochs as one program
        (als_ops.train_epochs; qmf_tpu's _fused_run): one host read, of the
        per-epoch losses, at the end. Returns them reference-normalized."""
        u, v, losses = als_ops.train_epochs(
            self._epoch_program(), self.item_factors, nepochs)
        self._own(u, v)
        return [loss / self.nusers / self.nitems for loss in losses.tolist()]

    def _can_fuse_run(self) -> bool:
        """True when no epoch needs the host before the next one (qmf_tpu's
        _can_fuse_run): fuse_epoch, no always-compute metrics, no
        checkpointing."""
        me = self.metrics_engine
        per_epoch_eval = (
            me is not None
            and me.test_avg_metrics
            and self.test_users is not None
            and len(self.test_users)
            and me.config.always_compute
        )
        return bool(
            self.config.fuse_epoch
            and not per_epoch_eval
            and not self._ckpt_dir
        )

    def _epoch(self) -> float:
        """One full epoch dispatched eagerly (:meth:`_epoch_body`,
        fuse_epoch=False); returns the reference-normalized item-side train
        loss."""
        self.user_factors, self.item_factors, loss = self._epoch_body()(
            self.item_factors)
        return float(loss) / self.nusers / self.nitems

    def enable_checkpointing(self, directory: str, every: int = 1) -> None:
        """Per-epoch checkpoint + auto-resume through utils/checkpoint.py,
        whose format is qmf_tpu's (a qmf_tpu checkpoint resumes here too)."""
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
        self._restore_factors(arrays)
        log.info("resumed from %s at epoch %d", path, epoch)
        return epoch + 1

    def _restore_factors(self, arrays) -> None:
        """Load checkpointed (unpadded) factors; through load_factors, which
        the sharded engine overrides to pad them to its heights."""
        self.load_factors(torch.from_numpy(arrays["user_factors"]),
                          torch.from_numpy(arrays["item_factors"]))

    def _checkpoint_arrays(self) -> dict:
        """The factors without padding rows, so a checkpoint does not
        depend on the number of ranks that wrote it."""
        return {
            "user_factors": self.user_factors[: self.nusers].cpu().numpy(),
            "item_factors": self.item_factors[: self.nitems].cpu().numpy(),
        }

    def _maybe_checkpoint(self, epoch: int) -> None:
        if self._ckpt_dir and epoch % self._ckpt_every == 0:
            ckpt.save_checkpoint(
                self._ckpt_dir,
                epoch,
                self._checkpoint_arrays(),
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
        start_epoch = self._maybe_resume()
        nepochs = self.config.nepochs
        if start_epoch <= nepochs and self._can_fuse_run():
            # the whole run as one program; the per-epoch losses are logged
            # afterwards in the per-epoch record format
            t0 = time.time()
            with annotate("wals_run"):
                losses = self._fused_run(nepochs - start_epoch + 1)
            elapsed = time.time() - t0
            for i, loss in enumerate(losses):
                log.info("epoch %d: train loss = %.10g (%.3fs)",
                         start_epoch + i, loss, elapsed / len(losses))
            self._check_finite(losses[-1], nepochs)
            if self.progress_cb is not None:
                self.progress_cb(nepochs, losses[-1], elapsed)
            self.evaluate(nepochs)
            return
        if start_epoch <= nepochs and not self.config.fuse_epoch:
            log.info("WALS epochs dispatched eagerly, one at a time "
                     "(fuse_epoch=False)")
        for epoch in range(start_epoch, nepochs + 1):
            t0 = time.time()
            with annotate(f"wals_epoch_{epoch}"):
                # float() of the loss waits for the device
                loss = (self._fused_epoch() if self.config.fuse_epoch
                        else self._epoch())
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
                self.item_factors[: self.nitems],
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
            self.user_factors[: self.nusers].cpu().numpy().astype(np.float64),
            self.user_index,
            file_name,
        )

    def save_item_factors(self, file_name: str) -> None:
        if self.item_factors is None:
            raise RuntimeError("item factors wasn't initialized")
        self.save_factor_data(
            self.item_factors[: self.nitems].cpu().numpy().astype(np.float64),
            self.item_index,
            file_name,
        )
