"""Engine configuration for the PyTorch port.

``WALSConfig`` keeps the reference field names and defaults of
``qmf_tpu.config.WALSConfig`` (reference qmf/wals/WALSEngine.h:35-42 and the
gflags defaults in qmf/wals.cpp:26-31), plus the knobs the port implements.
``MetricsConfig`` is a copy of ``qmf_tpu.config.MetricsConfig`` (same fields
and defaults).

Every enum is validated when the config is built, so a typo fails before any
data is read. ``qmf_tpu`` knobs that the port does not implement yet
(``device_pack``, ``class_solve``, ``fuse_epoch``) are not fields here; see
ROADMAP.md.
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


def _check_choice(name: str, value, choices) -> None:
    if value not in choices:
        raise ValueError(f"unknown WALS {name} {value!r} (expected one of {choices})")


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
    # Degree-class padding grid (qmf_tpu/ops/packing.py pad_widths).
    width_grid: str = "pow2_15"
    # Seed of the item-factor init when distribution_file is empty.
    init_seed: int = 0
    # Width-class coalescing (qmf_tpu/ops/packing.py coalesce_widths).
    max_width_classes: int = 12
    min_class_nnz_frac: float = 0.0
    # Hot/cold split build (ops/hot.py): the entries of each side's H hottest
    # fixed-side columns leave the gathered stream and enter A and b through
    # dense per-row weights (W_a @ Z, W_b @ y_hot). An int forces that H on
    # both sides; 0 disables. "auto" resolves to 0 in the port: qmf_tpu's
    # cost model was fitted on a TPU, and no H100 measurement shows yet that
    # the split pays (ROADMAP.md).
    hot_width: int | str = "auto"

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


@dataclasses.dataclass
class MetricsConfig:
    """Evaluation configuration (reference qmf/metrics/MetricsEngine.h:29-33)."""

    num_test_users: int = 0
    always_compute: bool = False
    seed: int = 42
