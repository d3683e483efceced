"""``bpr`` CLI of the PyTorch port — BPR training.

Flag-compatible with qmf_tpu.cli.bpr and the reference binary (reference
qmf/bpr.cpp:28-59): same names, defaults, and gflags syntax, plus
``--device``::

    python -m qmf_tpu_torch.cli.bpr -nfactors=30 -train_dataset=./ratings.csv \
        -user_factors=./user.dat -item_factors=./item.dat

``--num_hogwild_threads`` and ``--nthreads`` are accepted for compatibility;
the Hogwild concurrency role is played by the synchronous minibatch (see
``--batch_size``). ``--n_devices`` is qmf_tpu's: 1 trains on one device,
N > 1 runs the data-parallel ShardedBPREngine on N local ranks (one a card;
gloo ranks with ``--device=cpu``), 0 on every visible card; under torchrun
the process joins torchrun's group (parallel/launch.py ``run_cli``). Rank 0
logs and writes the factor files.
"""

from __future__ import annotations

import sys

from qmf_tpu_torch.config import BPRConfig, MetricsConfig
from qmf_tpu_torch.data import read_dataset
from qmf_tpu_torch.metrics import MetricsEngine
from qmf_tpu_torch.models import BPREngine
from qmf_tpu_torch.parallel import ShardedBPREngine, launch
from qmf_tpu_torch.utils import split
from qmf_tpu_torch.utils.flags import Flags
from qmf_tpu_torch.utils.logging import log


def make_flags() -> Flags:
    fl = Flags("bpr")
    # model arguments (reference qmf/bpr.cpp:28-40)
    fl.define_integer("nepochs", 10, "number of epochs for SGD")
    fl.define_integer("nfactors", 30, "dimension of learned factors")
    fl.define_float("init_learning_rate", 0.05, "initial learning rate")
    fl.define_float("bias_lambda", 1.0, "regularization on biases")
    fl.define_float("user_lambda", 0.025, "regularization on user factors")
    fl.define_float("item_lambda", 0.0025, "regularization on item factors")
    fl.define_float("decay_rate", 0.9, "decay rate on learning rate")
    fl.define_bool("use_biases", False, "use bias term")
    fl.define_float("init_distribution_bound", 0.01, "init distirbution bound")
    fl.define_integer(
        "num_negative_samples",
        3,
        "number of negative items to sample for each positive item",
    )
    fl.define_integer(
        "num_hogwild_threads",
        1,
        "reference compatibility; Hogwild concurrency is replaced by the "
        "synchronous device minibatch (--batch_size)",
    )
    fl.define_bool(
        "shuffle_training_set", True, "shuffle training set after each epoch"
    )
    # settings (reference qmf/bpr.cpp:43-45)
    fl.define_integer(
        "eval_num_neg",
        3,
        "number of negatives generated per positive in evaluation",
    )
    fl.define_integer(
        "eval_seed",
        42,
        "random seed for generating evaluation set and test users",
    )
    fl.define_integer("nthreads", 16, "reference compatibility; unused")
    # datasets (reference qmf/bpr.cpp:48-49)
    fl.define_string("train_dataset", "", "filename of training dataset")
    fl.define_string("test_dataset", "", "filename of test dataset")
    # metrics (reference qmf/bpr.cpp:52-56)
    fl.define_string(
        "test_avg_metrics",
        "",
        "comma-separated list of test metrics (averaged per-user)",
    )
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
    # model output (reference qmf/bpr.cpp:58-59)
    fl.define_string("user_factors", "", "filename of user factors")
    fl.define_string("item_factors", "", "filename of item factors")
    # port extras (qmf_tpu's, plus --device)
    fl.define_string("dtype", "float32", "tensor dtype: float32 | float64")
    fl.define_integer("batch_size", 8192, "triplets per device SGD step")
    fl.define_integer(
        "neg_resample_rounds", 4, "device negative-sampling rejection rounds"
    )
    fl.define_integer("init_seed", 0, "seed for factor init and shuffling")
    fl.define_string(
        "neg_sampler",
        "word",
        "grouped-epoch negative sampler: word (single-gather in-word "
        "probes) | rounds (compacted exact-rejection rounds)",
    )
    fl.define_integer(
        "n_devices", 1, "devices to train on: 1 = one device, N > 1 = "
        "data-parallel over N ranks, 0 = every visible CUDA device"
    )
    fl.define_string(
        "item_scatter",
        "seq",
        "grouped-epoch item-update strategy: seq (sequential scatter-adds) "
        "| merged (one wide scatter) | dense (summed into an accumulator); "
        "semantically identical",
    )
    fl.define_string("device", "cuda", "torch device: cuda | cuda:N | cpu")
    return fl


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    fl = make_flags()
    fl.parse(argv)
    rc = launch.run_cli(_rank_main, fl.n_devices, fl.device, argv)
    return _train(fl) if rc is None else rc


def _rank_main(mesh, argv) -> None:
    """One rank of a data-parallel run (launch.run_cli)."""
    fl = make_flags()
    fl.parse(argv)
    rc = _train(fl, mesh)
    if rc:
        raise SystemExit(rc)


def _train(fl, mesh=None) -> int:
    """Train as the flags say: on one device, or as a rank of ``mesh``."""
    if not fl.user_factors or not fl.item_factors:
        log.warning(
            "warning: missing model output filenames! "
            "(use options --{user,item}_factors)"
        )

    config = BPRConfig(
        nepochs=fl.nepochs,
        nfactors=fl.nfactors,
        init_learning_rate=fl.init_learning_rate,
        bias_lambda=fl.bias_lambda,
        user_lambda=fl.user_lambda,
        item_lambda=fl.item_lambda,
        decay_rate=fl.decay_rate,
        use_biases=fl.use_biases,
        init_distribution_bound=fl.init_distribution_bound,
        num_negative_samples=fl.num_negative_samples,
        num_hogwild_threads=fl.num_hogwild_threads,
        shuffle_training_set=fl.shuffle_training_set,
        dtype=fl.dtype,
        batch_size=fl.batch_size,
        neg_resample_rounds=fl.neg_resample_rounds,
        neg_sampler=fl.neg_sampler,
        init_seed=fl.init_seed,
        item_scatter=fl.item_scatter,
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

    if mesh is None:
        engine = BPREngine(
            config,
            metrics_engine,
            eval_num_neg=fl.eval_num_neg,
            eval_seed=fl.eval_seed,
            device=fl.device,
        )
    else:
        engine = ShardedBPREngine(
            config,
            metrics_engine,
            eval_num_neg=fl.eval_num_neg,
            eval_seed=fl.eval_seed,
            mesh=mesh,
        )
        log.info("data-parallel BPR over %d ranks (%s)", mesh.size,
                 mesh.backend)

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
