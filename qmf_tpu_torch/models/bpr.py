"""BPR training engine in PyTorch (port of qmf_tpu/models/bpr.py).

- ``init`` (reference BPREngine.cpp:65-105): keep elements with value >= 1.0
  as positive (user, item) pairs, index ids in first-occurrence order, build
  the per-user positive sets (CSR, and the packed bitmap or the blocked
  Bloom filter from one lexsort) on ``device``, pre-sample a fixed seeded
  train eval set, init factors/biases uniform(+-bound) from
  ``np.random.default_rng(init_seed)``, so a seed gives the same start as
  qmf_tpu.
- ``init_test`` (reference BPREngine.cpp:107-144): filter to known ids,
  build the test positive map, pre-sample the seeded test eval set
  (negatives rejected against the TEST map only, matching
  ``useTestItemMap=true``), and dense avg-metric test rows.
- ``optimize`` (reference BPREngine.cpp:146-176): the reference runs Hogwild
  lock-free SGD over ``num_hogwild_threads``. Here each epoch is a
  permutation of the positive pairs processed in minibatches of
  ``batch_size * num_negative_samples`` triplets; all updates in a batch read
  pre-batch parameters and scatter-add their gradients — the deterministic
  synchronous equivalent of Hogwild's unsynchronized concurrency.
  Each epoch is one program (``_epoch_program``): the grouped epoch (the
  presample and pack, then the SGD loop over every step: qmf_tpu's two
  programs as one) and the packed legacy epoch are each captured as one
  CUDA graph at the first epoch and replayed (ops/graphs.py); the legacy
  epoch with sampling inside each step is a graph of one step, replayed
  once a step with its step index on the device (qmf_tpu's ``lax.scan``
  body). The decaying rate is a device scalar, the draws come before the
  program; gloo ranks and the CPU run the same functions eagerly (decided
  once, logged).
- divergence guard: the reference CHECKs isfinite on every loss derivative
  (BPREngine.cpp:184-185); here factor finiteness is checked each epoch and
  raises with the same guidance.

Random numbers: the engine owns one ``torch.Generator`` on its device,
seeded from ``config.init_seed``, for the epochs' draws (the counterpart of
qmf_tpu's ``_step_key``), and seeds a fresh one from ``eval_seed`` for each
eval set. The two ``_draw_*`` methods are the only places an epoch draws;
everything below them takes the drawn integers (ops/bpr_ops.py). A
checkpoint stores the generator's state under qmf_tpu's name ``step_key``,
so a resumed run draws what a straight run would. The factor arrays of a
checkpoint are interchangeable between the two packages; the RNG state is
not (a JAX key is no torch generator state), and a resume from a qmf_tpu
checkpoint keeps the generator as seeded.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from qmf_tpu_torch.config import BPRConfig
from qmf_tpu_torch.data.dataset import Dataset
from qmf_tpu_torch.data.id_index import MISSING_IDX, IdIndex
from qmf_tpu_torch.models.engine import Engine
from qmf_tpu_torch.ops import als_ops, bpr_ops, graphs
from qmf_tpu_torch.ops.bpr_ops import BPRParams
from qmf_tpu_torch.utils import checkpoint as ckpt
from qmf_tpu_torch.utils import tracing
from qmf_tpu_torch.utils.logging import log

_DTYPES = {"float32": torch.float32, "float64": torch.float64}

# Rounds of the eval sets' rejection sampling (~exact), and the rows sampled
# at a time: bounds the (rounds, rows) candidate matrix on an eval set of
# tens of millions of rows.
_EVAL_ROUNDS = 16
_EVAL_SAMPLE_CHUNK = 4_000_000


def _stage_marker(stages: dict):
    """``mark(name)``: the seconds since the previous mark (or since this
    call) into ``stages[name]``."""
    last = [time.time()]

    def mark(name):
        now = time.time()
        stages[name] = round(now - last[0], 3)
        last[0] = now

    return mark


class BPREngine(Engine):
    # the ranks' Mesh of the sharded engine (parallel/sharded_bpr.py); None
    # runs every step here
    mesh = None

    def __init__(
        self,
        config: BPRConfig,
        metrics_engine=None,
        eval_num_neg: int = 3,
        eval_seed: int = 42,
        device: str | torch.device = "cuda",
    ):
        self.config = config
        self.metrics_engine = metrics_engine
        self.eval_num_neg = eval_num_neg
        self.eval_seed = eval_seed
        self.device = torch.device(device)
        self.dtype = _DTYPES[config.dtype]
        self.learning_rate = config.init_learning_rate
        # the test metrics' score matmul must be true fp32 on Hopper, as
        # WALSEngine's: set it here rather than inherit process state
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.user_index: Optional[IdIndex] = None
        self.item_index: Optional[IdIndex] = None
        self.params: Optional[BPRParams] = None
        self._data_users: Optional[np.ndarray] = None  # (n,) positive pairs
        self._data_items: Optional[np.ndarray] = None
        self._pos_set = None  # CSR per-user positive sets (device)
        self._pos_bitmap = None
        self._pos_bloom = None
        self._eval_set: Optional[tuple] = None  # (users, pos, neg) device
        self._test_eval_set: Optional[tuple] = None
        self.test_users: Optional[np.ndarray] = None
        self.test_labels: Optional[np.ndarray] = None
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(config.init_seed)
        self._grouped = False
        # the epoch as one program (_epoch_body's function, or a CUDA graph
        # of it: graphs.EpochGraph), made at the first epoch, with the
        # reasons it runs eagerly
        self._program = None
        self._eager_reasons: list = []
        self._grp_up = None  # (n_stream, 2) interleaved [user, item] rows
        self._last_overflow = None
        # colliders beyond the presampler's buffer, summed over the epochs
        # that evaluate has read
        self.overflow_slots = 0
        self._init_stages: dict = {}
        self._ckpt_dir: Optional[str] = None
        self._ckpt_every = 1
        # optional per-epoch progress hook:
        # fn(epoch, train_loss, test_loss, wall_s)
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

    @property
    def _grp_users(self) -> torch.Tensor:
        """Column view of the interleaved grouped stream (diagnostics)."""
        return self._grp_up[:, 0]

    @property
    def _grp_items(self) -> torch.Tensor:
        return self._grp_up[:, 1]

    def _to_device(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    # --- lifecycle -----------------------------------------------------------
    def init(self, dataset: Dataset) -> None:
        if self.params is not None:
            raise RuntimeError("engine was already initialized with train data")
        stages = self._init_stages = {}  # stage -> seconds (observability)
        mark = _stage_marker(stages)

        # positives: value >= 1.0, ids indexed in first-appearance order;
        # index + full-stream lookup come from ONE unique pass per side
        keep = dataset.values >= 1.0
        users_raw = dataset.user_ids[keep]
        items_raw = dataset.item_ids[keep]
        self.user_index, u_idx = IdIndex.from_first_occurrence_with_lookup(
            users_raw
        )
        self.item_index, i_idx = IdIndex.from_first_occurrence_with_lookup(
            items_raw
        )
        self._data_users = u_idx.astype(np.int32)
        self._data_items = i_idx.astype(np.int32)
        mark("index")

        # one lexsort feeds BOTH the CSR set and the bitmap build
        self._pos_set, sorted_u, sorted_i = bpr_ops.make_pos_set(
            self._data_users, self._data_items, self.nusers,
            return_sorted=True, device=self.device,
        )
        mark("pos_set")
        self._init_from_positives(sorted_u, sorted_i, mark)
        log.info("BPR init stages (s): %s", stages)

    def _init_from_positives(self, sorted_u: np.ndarray,
                             sorted_i: np.ndarray, mark) -> None:
        """init from the positive set on: the membership structure, the
        stream, the eval set and the parameters; ``sorted_u``/``sorted_i``
        are make_pos_set's lexsorted deduplicated pairs, ``mark(name)``
        closes each stage."""
        cfg = self.config
        # O(1) membership bitmap for the hot sampler when the id space
        # fits the budget (U*I/8 bytes). Beyond it, a blocked Bloom filter
        # (memory independent of n_items) + compacted exact CSR verify
        # keeps the grouped fast path at any catalog scale; plain CSR
        # binary search remains the final fallback.
        bitmap_bytes = self.nusers * ((self.nitems + 31) // 32) * 4
        # int32 word indexing bounds the exact bitmap regardless of budget;
        # beyond it the Bloom path (built for exactly that regime) takes over
        bitmap_feasible = (
            self.nusers * ((self.nitems + 31) // 32) < 2**31
        )
        self._pos_bloom = None
        if bitmap_feasible and bitmap_bytes <= cfg.bitmap_budget_mb * (1 << 20):
            self._pos_bitmap = bpr_ops.make_pos_bitmap(
                sorted_u, sorted_i, self.nusers, self.nitems,
                assume_lex_sorted=True, device=self.device,
            )
        else:
            self._pos_bitmap = None
            avg_deg = max(1, len(self._data_users) // max(1, self.nusers))
            bits = 1 << max(8, (cfg.bloom_bits_per_pos * avg_deg - 1)
                            .bit_length())
            bits = min(bits, 1 << 20)
            self._pos_bloom = bpr_ops.make_pos_bloom(
                self._data_users, self._data_items, self.nusers, bits,
                device=self.device,
            )
            log.info(
                "BPR positive set beyond exact-bitmap budget (%d MB > %d "
                "MB): blocked Bloom membership, %d bits/user (%.1f MB)",
                bitmap_bytes >> 20, cfg.bitmap_budget_mb, bits,
                self.nusers * bits / 8 / 2**20,
            )

        mark("membership")

        # grouped fast path: ONE stream row per positive pair; the row's
        # num_negative_samples negatives live as 2-bit round indices
        # (ops/bpr_ops.py sgd_epoch_grouped). Falls back to the legacy
        # triplet stream when preconditions fail.
        n_pos = len(self._data_users)
        grp_bs = min(cfg.batch_size, max(1, n_pos))
        if not cfg.grouped_epoch:
            reject = "disabled by config (grouped_epoch=False)"
        else:
            reject = bpr_ops.grouped_path_reject_reason(
                self.nusers,
                self.nitems,
                cfg.num_negative_samples,
                cfg.neg_resample_rounds,
                grp_bs,
                has_bitmap=(self._pos_bitmap is not None
                            or self._pos_bloom is not None),
            )
        if reject is not None:
            log.info(
                "BPR grouped fast path unavailable (%s): falling back to "
                "the triplet-stream epoch", reject,
            )
        self._grouped = reject is None
        self._last_overflow = None
        if self._grouped:
            self._grp_batch = grp_bs
            pad = (-n_pos) % grp_bs
            gu = np.concatenate(
                [self._data_users, np.zeros(pad, np.int32)]
            ) if pad else self._data_users
            gi = np.concatenate(
                [self._data_items, np.zeros(pad, np.int32)]
            ) if pad else self._data_items
            # interleaved [user, item] rows: the epoch shuffle is then ONE
            # row gather
            self._grp_up = self._to_device(
                np.stack([gu.astype(np.int32), gi.astype(np.int32)], axis=1)
            )
            self._n_real_pos = n_pos
            self._n_real_triplets = n_pos * cfg.num_negative_samples
            n_slots = len(gu) * cfg.num_negative_samples
            # expected collision rate of a uniform candidate:
            # P(cand in user's positives) averaged over stream slots
            # = sum_u deg(u)^2 / (n_pos * n_items). Dense small catalogs
            # (ml100k: ~8%) need a far larger buffer than sparse ones
            # (ml20m: ~0.7%); 3x headroom keeps overflows rare without a
            # config change per dataset. collide_cap_frac stays the floor.
            # Degrees are the DEDUPLICATED counts (collisions are tested
            # against the dedup set, so raw multiplicities would
            # overestimate p): one bincount of the lexsort's output.
            degs = np.bincount(sorted_u, minlength=self.nusers)
            p_est = float((degs.astype(np.float64) ** 2).sum()) / (
                max(1, n_pos) * max(1, self.nitems)
            )
            cap_frac = max(cfg.collide_cap_frac, min(0.5, 3.0 * p_est))
            if self._pos_bloom is not None:
                # bloom mode compacts true collisions PLUS ~5% false
                # positives; give the buffer extra headroom
                cap_frac = max(cap_frac, 1.0 / 8.0)
            self._collide_cap = max(1024, int(n_slots * cap_frac))
            log.info(
                "BPR grouped epoch path: %d positives (+%d pad) x %d "
                "negatives, batch %d, collision cap %d",
                n_pos, pad, cfg.num_negative_samples, grp_bs,
                self._collide_cap,
            )
        else:
            self._build_triplet_stream()
        mark("stream")

        self._post_stream_init()
        mark("eval_and_params")

    def _build_triplet_stream(self) -> None:
        """Legacy triplet stream: each positive pair repeated
        num_negative_samples times (reference iterate(),
        BPREngine-inl.h:21-29), padded to a batch multiple with zero
        weights."""
        cfg = self.config
        self._grouped = False
        tri_u = np.repeat(self._data_users, cfg.num_negative_samples)
        tri_i = np.repeat(self._data_items, cfg.num_negative_samples)
        self._n_real_triplets = len(tri_u)
        bs = min(cfg.batch_size, max(1, len(tri_u)))
        if (
            self._pos_bitmap is not None
            and self.nitems <= (1 << bpr_ops._PACK_SHIFT)
            and bs & (bs - 1) == 0
        ):
            # packed path: pad to a power of two so the epoch shuffle can
            # be a sort-free bijective index hash (bpr_ops._mix_bijection)
            n_pad = max(bs, 1 << (len(tri_u) - 1).bit_length())
            pad = n_pad - len(tri_u)
        else:
            pad = (-len(tri_u)) % bs
        w = np.ones(len(tri_u) + pad, dtype=np.float32)
        if pad:
            tri_u = np.concatenate([tri_u, np.zeros(pad, np.int32)])
            tri_i = np.concatenate([tri_i, np.zeros(pad, np.int32)])
            w[-pad:] = 0.0
        self._tri_users = self._to_device(tri_u.astype(np.int32))
        self._tri_items = self._to_device(tri_i.astype(np.int32))
        self._tri_weights = self._to_device(w, dtype=self.dtype)

    def _post_stream_init(self) -> None:
        # fixed seeded train eval set (reference BPREngine.cpp:84-87), its
        # negatives rejection-sampled on the device (16 rounds ~= exact)
        ev_u = torch.repeat_interleave(
            self._to_device(self._data_users), self.eval_num_neg
        )
        ev_p = torch.repeat_interleave(
            self._to_device(self._data_items), self.eval_num_neg
        )
        t0 = time.time()
        ev_n = self._sample_eval_negatives(ev_u)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._init_stages["eval_neg"] = round(time.time() - t0, 3)
        self._eval_set = (ev_u, ev_p, ev_n)

        # model init (reference BPREngine.cpp:89-104)
        cfg = self.config
        self.learning_rate = cfg.init_learning_rate
        init_rng = np.random.default_rng(cfg.init_seed)
        bound = cfg.init_distribution_bound
        uf = init_rng.uniform(-bound, bound, size=(self.nusers, cfg.nfactors))
        itf = init_rng.uniform(-bound, bound, size=(self.nitems, cfg.nfactors))
        ib = (
            init_rng.uniform(-bound, bound, size=self.nitems)
            if cfg.use_biases
            else np.zeros(self.nitems)
        )
        self.params = BPRParams(
            self._to_device(uf, dtype=self.dtype),
            self._to_device(itf, dtype=self.dtype),
            self._to_device(ib, dtype=self.dtype),
        )

    def init_test(self, test_dataset: Dataset) -> None:
        if self._test_eval_set is not None:
            raise RuntimeError("engine was already initialized with test data")
        uidx = self.user_index.lookup(test_dataset.user_ids)
        iidx = self.item_index.lookup(test_dataset.item_ids)
        valid = (
            (test_dataset.values >= 1.0)
            & (uidx != MISSING_IDX)
            & (iidx != MISSING_IDX)
        )
        t_users = uidx[valid].astype(np.int32)
        t_items = iidx[valid].astype(np.int32)

        # negatives rejected against the TEST positive map only
        # (reference BPREngine.cpp:126-136, useTestItemMap=true); sampled
        # on device like the train eval set
        ev_u = torch.repeat_interleave(
            self._to_device(t_users), self.eval_num_neg)
        ev_p = torch.repeat_interleave(
            self._to_device(t_items), self.eval_num_neg)
        if len(t_users):
            test_pos_set = bpr_ops.make_pos_set(
                t_users, t_items, self.nusers, device=self.device)
            ev_n = self._sample_eval_negatives(ev_u, pos_set=test_pos_set)
        else:
            ev_n = torch.zeros(0, dtype=torch.int32, device=self.device)
        self._test_eval_set = (ev_u, ev_p, ev_n)

        if self.metrics_engine is not None and self.metrics_engine.test_avg_metrics:
            self.test_users, self.test_labels = self.init_avg_test_data(
                test_dataset,
                self.user_index,
                self.item_index,
                self.metrics_engine.config.num_test_users,
                self.metrics_engine.config.seed,
            )

    def _sample_eval_negatives(self, ev_u, pos_set=None):
        """Rejection-sample eval negatives (seeded, fixed for all epochs),
        from a generator seeded with ``eval_seed``.

        ``pos_set``: reject against this CSR set instead of the train set
        (init_test passes the TEST positive map, reference
        useTestItemMap=true). The O(1) bitmap shortcut only applies to the
        train set. Rows are sampled ``_EVAL_SAMPLE_CHUNK`` at a time."""
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.eval_seed)
        bitmap = None
        if pos_set is None:
            pos_set, bitmap = self._pos_set, self._pos_bitmap
        outs = [
            bpr_ops.sample_negatives(
                generator, ev_u[start:start + _EVAL_SAMPLE_CHUNK], pos_set,
                self.nitems, rounds=_EVAL_ROUNDS, bitmap=bitmap,
            )
            for start in range(0, ev_u.shape[0], _EVAL_SAMPLE_CHUNK)
        ]
        return torch.cat(outs) if len(outs) != 1 else outs[0]

    # --- training -------------------------------------------------------------
    def _draw_grouped_keys(self):
        """The grouped epoch's draws (round keys, Feistel keys or None)."""
        cfg = self.config
        return bpr_ops.draw_grouped_keys(
            self._generator, cfg.neg_resample_rounds,
            cfg.shuffle_training_set)

    def _legacy_packed(self) -> bool:
        """Whether the legacy epoch takes its packed presampled path."""
        n = self._tri_users.shape[0]
        return not bpr_ops.packed_path_reasons(
            n, self.nitems, min(self.config.batch_size, n),
            self._pos_bitmap is not None, self._n_real_triplets)

    def _draw_legacy(self):
        """The legacy epoch's draws (bpr_ops.draw_epoch)."""
        cfg = self.config
        n = self._tri_users.shape[0]
        return bpr_ops.draw_epoch(
            self._generator, n, self.nitems, cfg.neg_resample_rounds,
            cfg.shuffle_training_set, min(cfg.batch_size, n),
            self._legacy_packed())

    def _membership(self):
        """The grouped sampler's membership structure: the exact bitmap,
        else the Bloom filter."""
        return (self._pos_bitmap if self._pos_bitmap is not None
                else self._pos_bloom)

    def _grouped_args(self) -> tuple:
        """The arguments of bpr_ops.grouped_epoch (and grouped_parts) for
        this engine's grouped path."""
        cfg = self.config
        return (self._grp_up, self._membership(), cfg.user_lambda,
                cfg.item_lambda, cfg.bias_lambda, self.nitems,
                self._n_real_pos, cfg.use_biases, cfg.num_negative_samples,
                cfg.neg_resample_rounds, self._grp_batch, self._collide_cap,
                cfg.shuffle_training_set,
                self._pos_set if self._pos_bloom is not None else None,
                cfg.item_scatter, cfg.neg_sampler, self.mesh)

    def _rate(self) -> torch.Tensor:
        """The rate as a 0-d tensor on the device: a captured program reads
        it there each epoch (it decays between epochs)."""
        return torch.full((), self.learning_rate, dtype=self.dtype,
                          device=self.device)

    def _grouped_inputs(self) -> tuple:
        """The grouped epoch program's inputs before the parameters: this
        epoch's draws and the rate, (rk, ks, lr), ``ks`` a placeholder
        when the epoch does not shuffle."""
        lr = self._rate()
        rk, ks = self._draw_grouped_keys()
        if ks is None:
            ks = bpr_ops.no_keys(6, self.device)
        return rk, ks, lr

    def _epoch_body(self):
        """The epoch of this engine's path as eager ops, a function of the
        epoch's draws, rate and parameters: bpr_ops.grouped_epoch (grouped),
        bpr_ops.packed_epoch (legacy, negatives presampled) or
        bpr_ops.instep_step (legacy, sampled inside each step: one step)."""
        cfg = self.config
        hyper = (cfg.user_lambda, cfg.item_lambda, cfg.bias_lambda)
        shuffle = cfg.shuffle_training_set
        if self._grouped:
            return bpr_ops.grouped_epoch(*self._grouped_args())
        batch = min(cfg.batch_size, self._tri_users.shape[0])
        if self._legacy_packed():
            return bpr_ops.packed_epoch(
                torch.stack([self._tri_users, self._tri_items], dim=1),
                self._pos_bitmap, self._n_real_triplets, *hyper,
                cfg.use_biases, batch, shuffle, self.mesh)
        bpr_ops.log_fallback(bpr_ops.packed_path_reasons(
            self._tri_users.shape[0], self.nitems, batch,
            self._pos_bitmap is not None, self._n_real_triplets))
        return bpr_ops.instep_step(
            self._tri_users, self._tri_items, self._tri_weights,
            self._pos_set.indptr, self._pos_set.items, *hyper,
            cfg.use_biases, self._pos_set.max_degree, batch, mesh=self.mesh)

    def _epoch_program(self):
        """The epoch as one program, made at the first epoch: a CUDA graph
        of :meth:`_epoch_body` captured at its first call (graphs.EpochGraph)
        where nothing in ``graphs.eager_reasons`` stands against it (the
        device, the mesh's backend), else the body itself. Decided once an
        engine, and logged."""
        if self._program is None:
            name = ("BPR grouped epoch" if self._grouped
                    else "BPR packed legacy epoch" if self._legacy_packed()
                    else "BPR in-step legacy step")
            self._program, self._eager_reasons = graphs.epoch_program(
                name, self._epoch_body(), self.device, self.mesh)
        return self._program

    def _epoch(self) -> None:
        """One epoch: this epoch's draws, then the epoch's program on them
        (shuffle + sample + all steps). The program's call is the host span
        ``bpr_launch``: on a card the inputs' copies and the graph's launch,
        elsewhere the eager epoch."""
        program = self._epoch_program()
        if self._grouped:
            inputs = self._grouped_inputs()
            with tracing.annotate("bpr_launch"):
                *params, self._last_overflow = program(*inputs, *self.params)
        elif self._legacy_packed():
            ks, cands = self._draw_legacy()
            if ks is None:
                ks = bpr_ops.no_keys(3, self.device)
            rate = self._rate()
            with tracing.annotate("bpr_launch"):
                params = program(ks, cands, rate, *self.params)
        else:
            perm, cands = self._draw_legacy()
            if perm is None:
                perm = bpr_ops.stream_rows(self._tri_users.shape[0],
                                           self.device)
            step = torch.zeros((), dtype=torch.int64, device=self.device)
            inputs = (step, perm, cands, self._rate(), *self.params)
            with tracing.annotate("bpr_launch"):
                _, *params = graphs.run_steps(program, inputs,
                                              cands.shape[0])
        # a graph's outputs are its static buffers: the parameters it
        # updates in place, which the next replay reads where they are
        self.params = BPRParams(*params)

    def enable_checkpointing(self, directory: str, every: int = 1) -> None:
        """Per-epoch checkpoint + auto-resume (utils/checkpoint.py)."""
        self._ckpt_dir = directory
        self._ckpt_every = max(1, every)

    def _maybe_resume(self) -> int:
        if not self._ckpt_dir:
            return 1
        path = ckpt.latest_checkpoint(self._ckpt_dir)
        if path is None:
            return 1
        epoch, arrays, meta = ckpt.load_checkpoint(path)
        self.params = BPRParams(*(
            self._to_device(arrays[name], dtype=self.dtype)
            for name in ("user_factors", "item_factors", "item_biases")
        ))
        self.learning_rate = float(meta["learning_rate"])
        state = arrays.get("step_key")
        if state is not None and state.dtype == np.uint8:
            # restore RNG state so resumed epochs draw the same
            # shuffle/negative-sample sequence a straight run would
            self._generator.set_state(torch.from_numpy(state.copy()))
        elif state is not None:
            log.warning(
                "checkpoint %s holds a qmf_tpu PRNG key, not a torch "
                "generator state: the factors resume, the draws start "
                "from init_seed", path,
            )
        log.info("resumed from %s at epoch %d", path, epoch)
        return epoch + 1

    def _maybe_checkpoint(self, epoch: int) -> None:
        if self._ckpt_dir and epoch % self._ckpt_every == 0:
            ckpt.save_checkpoint(
                self._ckpt_dir,
                epoch,
                {
                    "user_factors": self.params.user_factors.cpu().numpy(),
                    "item_factors": self.params.item_factors.cpu().numpy(),
                    "item_biases": self.params.item_biases.cpu().numpy(),
                    # post-epoch generator state (uint8)
                    "step_key": self._generator.get_state().cpu().numpy(),
                },
                meta={
                    "engine": "bpr",
                    "learning_rate": self.learning_rate,
                },
            )

    def optimize(self) -> None:
        if self.params is None:
            raise RuntimeError(
                "no factor data, have you initialized the engine?"
            )
        cfg = self.config
        start_epoch = self._maybe_resume()
        for epoch in range(start_epoch, cfg.nepochs + 1):
            t0 = time.time()
            with tracing.annotate(f"bpr_epoch_{epoch}"):
                self._epoch()
            # divergence guard (reference CHECK(isfinite), BPREngine.cpp:184);
            # reading it waits for the epoch's device work (span bpr_wait)
            with tracing.annotate("bpr_wait"):
                finite = bool(torch.isfinite(self.params.user_factors).all())
            if not finite:
                raise FloatingPointError(
                    "gradients too big, try decreasing the learning rate "
                    "(--init_learning_rate)"
                )
            self.evaluate(epoch, elapsed=time.time() - t0)
            # decay BEFORE checkpointing so a resumed run continues with the
            # same learning rate a straight run would use for epoch+1
            # (reference decays at end of epoch too, BPREngine.cpp:169-171)
            if cfg.decay_rate < 1.0:
                self.learning_rate *= cfg.decay_rate
            self._maybe_checkpoint(epoch)

    def _eval_set_loss(self, eval_set) -> float:
        """The mean loss over ``eval_set`` (the part ``bpr_eval``), -1 for
        none."""
        if eval_set is None or not eval_set[0].shape[0]:
            return -1.0
        with tracing.part("bpr_eval", self.device):
            loss = bpr_ops.eval_loss(
                self.params, *eval_set, use_biases=self.config.use_biases)
        return float(loss)

    def evaluate(self, epoch: int, elapsed: float = 0.0) -> None:
        cfg = self.config
        train_loss = self._eval_set_loss(self._eval_set)
        test_loss = self._eval_set_loss(self._test_eval_set)
        log.info(
            "epoch %d: train loss = %.10g, test loss = %.10g (%.3fs)",
            epoch,
            train_loss,
            test_loss,
            elapsed,
        )
        if self.progress_cb is not None:
            self.progress_cb(epoch, train_loss, test_loss, elapsed)
        if self._last_overflow is not None:
            overflow = int(self._last_overflow)
            self._last_overflow = None
            self.overflow_slots += overflow
            if overflow > 0:
                log.warning(
                    "BPR presampler collision buffer overflowed by %d "
                    "slots (those kept a colliding candidate); raise "
                    "collide_cap_frac",
                    overflow,
                )

        me = self.metrics_engine
        if (
            me is not None
            and me.test_avg_metrics
            and self.test_users is not None
            and len(self.test_users)
            and (me.config.always_compute or epoch == cfg.nepochs)
        ):
            scores = als_ops.compute_scores(
                self.params.user_factors,
                self.params.item_factors,
                item_biases=(
                    self.params.item_biases if cfg.use_biases else None
                ),
                user_idx=self._to_device(self.test_users),
            )
            me.compute_and_record_test_avg_metrics(
                epoch, self.test_labels, scores
            )

    # --- output ----------------------------------------------------------------
    def save_user_factors(self, file_name: str) -> None:
        if self.params is None:
            raise RuntimeError("user factors wasn't initialized")
        self.save_factor_data(
            self.params.user_factors.cpu().numpy().astype(np.float64),
            self.user_index,
            file_name,
        )

    def save_item_factors(self, file_name: str) -> None:
        if self.params is None:
            raise RuntimeError("item factors wasn't initialized")
        self.save_factor_data(
            self.params.item_factors.cpu().numpy().astype(np.float64),
            self.item_index,
            file_name,
            biases=(
                self.params.item_biases.cpu().numpy().astype(np.float64)
                if self.config.use_biases
                else None
            ),
        )
