"""``wals`` CLI of the PyTorch port — single-device WALS training.

Flag-compatible with qmf_tpu.cli.wals and the reference binary (reference
qmf/wals.cpp:26-50), plus ``--device``::

    python -m qmf_tpu_torch.cli.wals -nfactors=30 -train_dataset=./ratings.csv \
        -user_factors=./user.dat -item_factors=./item.dat

A uniform init file for ``--distribution_file`` comes from
``python -m qmf_tpu_torch.cli.gen_uniform``. ``--nthreads`` is accepted for
compatibility. Only ``--n_devices=1`` runs: multi-device training is not
ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import sys

from qmf_tpu_torch.config import MetricsConfig, WALSConfig
from qmf_tpu_torch.data import read_dataset
from qmf_tpu_torch.metrics import MetricsEngine
from qmf_tpu_torch.models import WALSEngine
from qmf_tpu_torch.utils import split
from qmf_tpu_torch.utils.flags import Flags
from qmf_tpu_torch.utils.logging import log


def make_flags() -> Flags:
    fl = Flags("wals")
    # model arguments (reference qmf/wals.cpp:26-31)
    fl.define_integer("nepochs", 10, "number of epochs for ALS")
    fl.define_integer("nfactors", 30, "dimension of learned factors")
    fl.define_float("regularization_lambda", 0.05, "regularization param")
    fl.define_float("confidence_weight", 40, "confidence weight")
    fl.define_float("init_distribution_bound", 0.01, "init distirbution bound")
    fl.define_string(
        "distribution_file",
        "",
        "uniform distribution file, for repeatable result",
    )
    # settings (reference qmf/wals.cpp:34)
    fl.define_integer(
        "nthreads",
        16,
        "accepted for reference compatibility; parallelism comes from "
        "batched device work",
    )
    # datasets (reference qmf/wals.cpp:37-38)
    fl.define_string("train_dataset", "", "filename of training dataset")
    fl.define_string("test_dataset", "", "filename of test dataset")
    # metrics (reference qmf/wals.cpp:41-47)
    fl.define_string(
        "test_avg_metrics",
        "",
        "comma-separated list of test metrics (averaged per-user)",
    )
    fl.define_integer("eval_seed", 42, "random seed for picking test users")
    fl.define_integer(
        "num_test_users",
        0,
        "# users to use for computing test avg metrics (0 = all users)",
    )
    fl.define_bool(
        "test_always",
        False,
        "whether to compute test avg metrics after each epoch (if false, "
        "only computes at the end)",
    )
    # model output (reference qmf/wals.cpp:49-50)
    fl.define_string("user_factors", "", "filename of user factors")
    fl.define_string("item_factors", "", "filename of item factors")
    # port extras
    fl.define_string("dtype", "float32", "tensor dtype: float32 | float64")
    fl.define_string(
        "solver",
        "auto",
        "per-row solver: kernel (hand-written CUDA solve) | fused "
        "(hand-written CUDA build+solve, float32 only) | cholesky (plain "
        "torch) | lu | auto (kernel on a CUDA device, cholesky elsewhere)",
    )
    fl.define_integer("batch_rows", 4096, "max rows per build chunk")
    fl.define_string(
        "width_grid",
        "pow2_15",
        "degree-class padding grid: pow2 | pow2_15 (1.5x points) | pow2_q "
        "(quarter points)",
    )
    fl.define_string(
        "matmul_precision",
        "highest",
        "normal-equation build precision: highest (fp32) | default (bf16 "
        "operands, fp32 accumulation)",
    )
    fl.define_integer(
        "init_seed", 0, "seed for random item-factor init (reference uses "
        "a non-deterministic random_device)"
    )
    fl.define_integer(
        "n_devices", 1, "devices to train on; the port runs only 1"
    )
    fl.define_string("device", "cuda", "torch device: cuda | cuda:N | cpu")
    return fl


def main(argv=None) -> int:
    fl = make_flags()
    fl.parse(argv)
    if fl.n_devices != 1:
        raise ValueError(
            f"--n_devices={fl.n_devices}: the port trains on one device "
            "only; multi-device WALS (qmf_tpu/parallel) is queued in "
            "ROADMAP.md"
        )

    if not fl.user_factors or not fl.item_factors:
        log.warning(
            "warning: missing model output filenames! "
            "(use options --{user,item}_factors)"
        )

    config = WALSConfig(
        nepochs=fl.nepochs,
        nfactors=fl.nfactors,
        regularization_lambda=fl.regularization_lambda,
        confidence_weight=fl.confidence_weight,
        init_distribution_bound=fl.init_distribution_bound,
        distribution_file=fl.distribution_file,
        dtype=fl.dtype,
        solver=fl.solver,
        batch_rows=fl.batch_rows,
        matmul_precision=fl.matmul_precision,
        width_grid=fl.width_grid,
        init_seed=fl.init_seed,
    )
    metrics_config = MetricsConfig(
        num_test_users=fl.num_test_users,
        always_compute=fl.test_always,
        seed=fl.eval_seed,
    )
    metrics_engine = MetricsEngine(metrics_config)
    for metric in split(fl.test_avg_metrics, ","):
        if not metrics_engine.add_test_avg_metric(metric):
            log.error("metric %s is not available", metric)
            return 1

    engine = WALSEngine(config, metrics_engine, device=fl.device)

    log.info("loading training data")
    engine.init(read_dataset(fl.train_dataset))

    if fl.test_dataset:
        log.info("loading test data")
        engine.init_test(read_dataset(fl.test_dataset))

    log.info("training")
    engine.optimize()

    if fl.user_factors and fl.item_factors:
        log.info("saving model output")
        engine.save_user_factors(fl.user_factors)
        engine.save_item_factors(fl.item_factors)
    return 0


if __name__ == "__main__":
    sys.exit(main())
