"""Engine configuration for the PyTorch port.

``WALSConfig`` has every field of ``qmf_tpu.config.WALSConfig`` with its
default (the reference's names and defaults, qmf/wals/WALSEngine.h:35-42 and
the gflags defaults in qmf/wals.cpp:26-31, and qmf_tpu's knobs), and
``BPRConfig`` every field of ``qmf_tpu.config.BPRConfig`` with its default.
``MetricsConfig`` is a copy of ``qmf_tpu.config.MetricsConfig`` (same fields
and defaults).

Every enum is validated when the config is built, so a typo fails before any
data is read.
"""

from __future__ import annotations

import dataclasses

DTYPES = ("float32", "float64")
SOLVERS = ("auto", "kernel", "fused", "cholesky", "lu")
MATMUL_PRECISIONS = ("highest", "default")
WIDTH_GRIDS = ("pow2", "pow2_15", "pow2_q")

# qmf_tpu solver names the port rejects, with the reason.
_REJECTED_SOLVERS = {
    "pallas": "is the TPU kernel; the port's hand-written CUDA kernel is "
    "solver='kernel'",
    "cholesky_matmul": "exists only for TPU XLA (qmf_tpu/ops/linalg.py:1-9)",
    "schur": "exists only for TPU XLA (qmf_tpu/ops/linalg.py:1-9)",
    "cholesky_xla": "exists only for TPU XLA (qmf_tpu/ops/linalg.py:1-9)",
}


NEG_SAMPLERS = ("word", "rounds")
ITEM_SCATTERS = ("seq", "merged", "dense")


def _check_choice(name: str, value, choices, algo: str = "WALS") -> None:
    if value not in choices:
        raise ValueError(
            f"unknown {algo} {name} {value!r} (expected one of {choices})")


@dataclasses.dataclass
class WALSConfig:
    """Weighted-ALS hyperparameters (Hu/Koren/Volinsky implicit feedback)."""

    nepochs: int = 10
    nfactors: int = 30
    regularization_lambda: float = 0.05
    confidence_weight: float = 40.0
    init_distribution_bound: float = 0.01
    # One float per line, row-major item-factor init (reference
    # qmf/FactorData.h:74-100).
    distribution_file: str = ""

    # --- port knobs (no reference equivalent) ---
    # Tensor dtype; the reference computes in float64 (qmf/Types.h:24).
    dtype: str = "float32"
    # "auto" resolves to "kernel" (the hand-written CUDA factor+solve) on a
    # CUDA device when k fits its shared memory, and to "cholesky" (plain
    # torch.linalg.cholesky_ex + cholesky_solve) otherwise. "fused" builds
    # and solves each row's normal equations in one hand-written CUDA kernel
    # (ops/build_solve.py; its plain version on the CPU), float32 only. "lu"
    # is the general solve that tolerates indefinite systems like dsysv_.
    solver: str = "auto"
    # Max rows per build chunk at the narrowest width (bounds the gathered
    # working set; wider classes take proportionally fewer rows).
    batch_rows: int = 4096
    # Normal-equation build precision: "highest" is true fp32 (TF32 off);
    # "default" rounds the gathered factors and weights to bf16 and
    # accumulates A and b in fp32.
    matmul_precision: str = "highest"
    # Run each epoch as one device program (qmf_tpu/config.py:57-60), and
    # the whole run as one when no epoch needs the host in between (no
    # checkpoints, no always-compute metrics). On a CUDA device the epoch
    # is captured once as a CUDA graph and replayed (ops/graphs.py), where
    # the solver and the ranks' backend allow a capture; elsewhere it runs
    # as eager ops, the run's losses kept on the device until its end.
    # False dispatches every epoch eagerly and logs it as it ends.
    fuse_epoch: bool = True
    # Solve granularity of the split path (qmf_tpu/config.py:61-66): True
    # stacks each width class's normal equations from its chunked build and
    # solves the class in one batched call; False solves each chunk as it
    # is built, holding one chunk's A instead of the class's (lower peak
    # memory). Both give the same factors. solver="fused" ignores it.
    class_solve: bool = True
    # Degree-class padding grid (qmf_tpu/ops/packing.py pad_widths).
    width_grid: str = "pow2_15"
    # Seed of the item-factor init when distribution_file is empty.
    init_seed: int = 0
    # Width-class coalescing (qmf_tpu/ops/packing.py coalesce_widths).
    max_width_classes: int = 12
    min_class_nnz_frac: float = 0.0
    # Hot/cold split build (ops/hot.py): the entries of each side's H hottest
    # fixed-side columns leave the gathered stream and enter A and b through
    # dense per-row weights (W_a @ Z, W_b @ y_hot). "auto" picks H for each
    # side by itself, as qmf_tpu does, through ops/hot.py's cost model with
    # its H100 constants (tools/hot_micro.py fits them), on float32 on a
    # CUDA device, and is 0 on the CPU and in float64. An int forces that H
    # on both sides; 0 disables.
    hot_width: int | str = "auto"
    # Build the width classes on the device (ops/device_pack.py): the COO
    # goes to the card once and is sorted and gathered there, instead of
    # packed in numpy and copied. "auto" is on for float32 on a CUDA device
    # and off on the CPU and for float64, as in qmf_tpu; the sharded engine
    # packs on the host at a world of more than one rank.
    device_pack: bool | str = "auto"

    def __post_init__(self) -> None:
        if self.solver in _REJECTED_SOLVERS:
            raise ValueError(
                f"WALS solver {self.solver!r} "
                f"{_REJECTED_SOLVERS[self.solver]}"
            )
        _check_choice("solver", self.solver, SOLVERS)
        _check_choice("dtype", self.dtype, DTYPES)
        _check_choice(
            "matmul_precision", self.matmul_precision, MATMUL_PRECISIONS
        )
        _check_choice("width_grid", self.width_grid, WIDTH_GRIDS)
        if self.solver == "fused" and self.dtype != "float32":
            raise ValueError(
                f"WALS solver 'fused' runs in float32 only, not "
                f"{self.dtype!r}: the build+solve kernel accumulates and "
                "solves in f32, as qmf_tpu's fused kernel does "
                "(qmf_tpu/ops/pallas_solve.py:483-491)"
            )
        hw = self.hot_width
        if hw != "auto" and (
            isinstance(hw, bool) or not isinstance(hw, int) or hw < 0
        ):
            raise ValueError(
                f"WALS hot_width must be 'auto' or an int >= 0, got {hw!r}"
            )
        if not (self.device_pack == "auto"
                or isinstance(self.device_pack, bool)):
            raise ValueError(
                "WALS device_pack must be 'auto', True or False, got "
                f"{self.device_pack!r}"
            )


@dataclasses.dataclass
class BPRConfig:
    """BPR-SGD hyperparameters."""

    nepochs: int = 10
    nfactors: int = 30
    init_learning_rate: float = 0.05
    bias_lambda: float = 1.0
    user_lambda: float = 0.025
    item_lambda: float = 0.0025
    decay_rate: float = 0.9
    use_biases: bool = False
    init_distribution_bound: float = 0.01
    num_negative_samples: int = 3
    # Reference meaning: Hogwild thread count (qmf/bpr/BPREngine.cpp:153-164).
    # Here it has no effect on the math: Hogwild's asynchronous races are
    # replaced by synchronous vectorized minibatches (see BPREngine docs).
    # Kept for CLI compatibility.
    num_hogwild_threads: int = 1
    shuffle_training_set: bool = True

    # --- port knobs (qmf_tpu's, with its defaults) ---
    dtype: str = "float32"
    # Triplets per device step. Plays the role Hogwild's concurrency played:
    # updates within a batch read the same (pre-batch) parameters, like
    # concurrent Hogwild threads reading unsynchronized state.
    batch_size: int = 8192
    # Rounds of negative re-sampling for candidates that collide with the
    # user's positive set (reference rejection loop BPREngine-inl.h:48-60).
    neg_resample_rounds: int = 4
    # Accepted for compatibility with qmf_tpu, where it picks between a
    # looped and an unrolled binary search that give equal results; the
    # port's membership search has one form.
    unroll_membership: bool = False
    # Memory budget (MB) for the dense packed (user, item) membership
    # bitmap used by the negative sampler: ONE random gather per candidate
    # instead of ~log2(max_degree) chained binary-search gathers, and the
    # enabler of the shared-word sampler. The bitmap lives in device memory
    # (sparse-built on device, so host/transfer cost scales with nnz not
    # U*I). Above the budget (U*I/8 bytes) the sampler falls back to
    # blocked-Bloom membership + exact CSR verify.
    bitmap_budget_mb: int = 4096
    # Grouped packed epochs (one stream row per positive, negatives
    # reconstructed from 2-bit round indices — ops/bpr_ops.py
    # sgd_epoch_grouped). Preconditions checked by grouped_path_reject_reason;
    # set False to force the legacy triplet-stream paths.
    grouped_epoch: bool = True
    # Capacity of the compacted collision buffer in the grouped presampler,
    # as a fraction of the negative-slot count. Colliders beyond the cap
    # keep their (positive) round-0 candidate — the engine logs when that
    # happens. 1/16 covers avg_degree/n_items collision rates up to ~6%.
    collide_cap_frac: float = 1.0 / 16.0
    # Item-side scatter strategy for the grouped epoch's 1+num_neg B-row
    # updates per step. "seq": sequential index_add_ calls on the live
    # table. "merged": one wide (1+num_neg)*B-row index_add_. "dense":
    # sum the update stream into a fresh zeroed (n_items, k) accumulator
    # and add it densely. All three are semantically identical
    # (duplicate-index contributions sum either way).
    item_scatter: str = "seq"
    # Negative-sampler strategy for the grouped epoch when the exact bitmap
    # is available. "word": each positive ROW gathers ONE bitmap word; slot
    # j's probe rounds r < R-1 test spread-out bits of that word
    # (distinct-mod-32 offsets per slot/round) and round R-1 is a fresh
    # unchecked candidate, with residual positive-candidate probability
    # ~p^2 vs p^R. "rounds": the compacted exact-rejection sampler (each
    # round an independent uniform candidate). Bloom-membership catalogs and
    # configs with num_neg*(rounds-1) > 15 always use "rounds" (+ CSR verify
    # on bloom).
    neg_sampler: str = "word"
    # Blocked-Bloom membership for catalogs beyond the exact-bitmap budget
    # (ops/bpr_ops.py PosBloom): per-user block sized to
    # next_pow2(bloom_bits_per_pos * avg_degree) bits, clamped to
    # [256, 2^20]. 8 bits/positive => ~5% false-positive rate with the
    # 2-hash scheme; memory is U * block/8 bytes, independent of n_items.
    bloom_bits_per_pos: int = 8
    init_seed: int = 0

    def __post_init__(self) -> None:
        _check_choice("neg_sampler", self.neg_sampler, NEG_SAMPLERS, "BPR")
        _check_choice("item_scatter", self.item_scatter, ITEM_SCATTERS, "BPR")
        _check_choice("dtype", self.dtype, DTYPES, "BPR")


@dataclasses.dataclass
class MetricsConfig:
    """Evaluation configuration (reference qmf/metrics/MetricsEngine.h:29-33)."""

    num_test_users: int = 0
    always_compute: bool = False
    seed: int = 42
