"""End to end: the port's WALSEngine and CLI against qmf_tpu's.

One seeded 200 x 120 dataset goes through both engines. In float64 the
per-epoch losses and the factors agree to 1e-9 (the JAX engine uses
solver="lu", which compiles fast; the port solves with plain cholesky, as
"auto" resolves on the CPU). In float32 at "highest" the port stays within
2e-3 of the f64 run, the f32-vs-f64 gap of the reference. Factors carried
over from JAX (numpy arrays or a checkpoint directory) continue to the same
result as a run that never left JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from qmf_tpu.cli import wals as jax_cli
from qmf_tpu.config import WALSConfig as JaxWALSConfig
from qmf_tpu.data import load_factors
from qmf_tpu.data.dataset import Dataset, write_dataset
from qmf_tpu.models.wals import WALSEngine as JaxWALSEngine
from qmf_tpu_torch.cli import wals as port_cli
from qmf_tpu_torch.config import WALSConfig
from qmf_tpu_torch.convert import factors_from_jax
from qmf_tpu_torch.models import WALSEngine

torch.set_num_threads(1)

NEPOCHS, K = 3, 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(seed=0, n_u=200, n_i=120, nnz=3000):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n_u * n_i, nnz))
    return Dataset(key // n_i + 1, key % n_i + 1,
                   rng.integers(1, 11, len(key)) * 0.5)


def _port_run(dataset, nepochs=NEPOCHS, **kw):
    # fuse_epoch=False: one progress_cb a epoch, as the JAX runs here
    losses = []
    eng = WALSEngine(WALSConfig(nepochs=nepochs, nfactors=K, batch_rows=64,
                                fuse_epoch=False, **kw), device="cpu")
    eng.progress_cb = lambda epoch, loss, dt: losses.append(loss)
    eng.init(dataset)
    return eng, losses


def _jax_config(nepochs):
    return JaxWALSConfig(nepochs=nepochs, nfactors=K, dtype="float64",
                         solver="lu", fuse_epoch=False, batch_rows=64)


@pytest.fixture(scope="module")
def jax_run():
    """A 3-epoch float64 JAX run: per-epoch losses, final factors, and the
    factors after epoch 2."""
    ds = _dataset()
    eng = JaxWALSEngine(_jax_config(NEPOCHS))
    losses, after = [], {}

    def cb(epoch, loss, dt):
        losses.append(loss)
        after[epoch] = (np.asarray(eng.user_factors),
                        np.asarray(eng.item_factors))

    eng.progress_cb = cb
    eng.init(ds)
    eng.optimize()
    return ds, losses, after


def _assert_factors(eng, want, atol=1e-9, rtol=1e-9):
    for got, w in zip((eng.user_factors, eng.item_factors), want):
        np.testing.assert_allclose(got.cpu().numpy(), w, rtol=rtol, atol=atol)


def test_f64_matches_jax_per_epoch(jax_run):
    ds, jax_losses, after = jax_run
    eng, losses = _port_run(ds, dtype="float64")
    assert eng._solver == "cholesky"  # "auto" on the CPU
    eng.optimize()
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-9, atol=1e-9)
    _assert_factors(eng, after[NEPOCHS])


def test_f32_highest_within_f32_gap_of_jax_f64(jax_run):
    ds, jax_losses, after = jax_run
    eng, losses = _port_run(ds, dtype="float32", matmul_precision="highest")
    eng.optimize()
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-3, atol=2e-3)
    _assert_factors(eng, after[NEPOCHS], atol=2e-3, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("solver", ["kernel", "lu"])
def test_engine_tensors_keep_config_dtype(dtype, solver):
    eng, _ = _port_run(_dataset(seed=1, n_u=40, n_i=30, nnz=300), nepochs=1,
                       dtype=dtype, solver=solver)
    eng.optimize()
    want = getattr(torch, dtype)
    assert eng.user_factors.dtype == eng.item_factors.dtype == want
    assert all(c[2].dtype == want for c in eng._user_classes)
    assert np.isfinite(eng.user_factors.numpy()).all()


def test_two_jax_epochs_plus_one_port_epoch(jax_run):
    ds, _, after = jax_run
    eng, losses = _port_run(ds, nepochs=1, dtype="float64")
    u, v = factors_from_jax(*after[2], device="cpu", dtype=torch.float64)
    eng.load_factors(u, v)
    eng.optimize()
    _assert_factors(eng, after[3])


def test_jax_checkpoint_resumes_in_port(jax_run, tmp_path):
    ds, jax_losses, after = jax_run
    jeng = JaxWALSEngine(_jax_config(2))
    jeng.enable_checkpointing(str(tmp_path))
    jeng.init(ds)
    jeng.optimize()
    eng, losses = _port_run(ds, dtype="float64")
    eng.enable_checkpointing(str(tmp_path))
    eng.optimize()
    assert len(losses) == 1  # resumed at epoch 3
    assert losses[0] == pytest.approx(jax_losses[2], rel=1e-9)
    _assert_factors(eng, after[3])


def test_load_factors_rejects_wrong_shape():
    eng, _ = _port_run(_dataset(seed=2, n_u=20, n_i=10, nnz=100), nepochs=1)
    with pytest.raises(ValueError):
        eng.load_factors(torch.zeros(3, K), torch.zeros(eng.nitems, K))


def test_nonfinite_loss_raises_with_remediation():
    with pytest.raises(FloatingPointError, match="float64"):
        WALSEngine._check_finite(float("nan"), epoch=3)
    WALSEngine._check_finite(0.25, epoch=3)


@pytest.mark.parametrize(
    "kw,match",
    [
        ({"solver": "fused", "dtype": "float64"}, "float32 only"),
        ({"solver": "pallas"}, "kernel"),
        ({"solver": "cholesky_matmul"}, "TPU XLA"),
        ({"solver": "schur"}, "TPU XLA"),
        ({"solver": "cholesky_xla"}, "TPU XLA"),
        ({"solver": "bogus"}, "solver"),
        ({"dtype": "float16"}, "dtype"),
        ({"matmul_precision": "high"}, "matmul_precision"),
        ({"width_grid": "pow3"}, "width_grid"),
        ({"hot_width": -1}, "hot_width"),
        ({"hot_width": "wide"}, "hot_width"),
    ],
)
def test_config_rejects_bad_enums(kw, match):
    with pytest.raises(ValueError, match=match):
        WALSConfig(**kw)


@pytest.fixture
def text_data(tmp_path):
    ds = _dataset(seed=5, n_u=60, n_i=40, nnz=900)
    rng = np.random.default_rng(5)
    test = rng.random(len(ds)) < 0.1
    train_p, test_p = tmp_path / "train.txt", tmp_path / "test.txt"
    write_dataset(Dataset(ds.user_ids[~test], ds.item_ids[~test],
                          ds.values[~test]), str(train_p))
    write_dataset(Dataset(ds.user_ids[test], ds.item_ids[test],
                          ds.values[test]), str(test_p))
    return train_p, test_p


def test_cli_writes_what_the_jax_cli_writes(tmp_path, text_data):
    train_p, test_p = text_data
    common = [f"--train_dataset={train_p}", f"--test_dataset={test_p}",
              "--nepochs=2", "--nfactors=4", "--dtype=float64",
              "--test_avg_metrics=auc,p@5"]
    outs = {}
    for name, main, extra in (
        ("jax", jax_cli.main, ["--solver=lu"]),
        ("port", port_cli.main, ["--device=cpu"]),
    ):
        u, i = tmp_path / f"{name}_u.dat", tmp_path / f"{name}_i.dat"
        assert main(common + extra + [f"--user_factors={u}",
                                      f"--item_factors={i}"]) == 0
        outs[name] = [load_factors(str(p)) for p in (u, i)]
    for (ids_p, fd_p), (ids_j, fd_j) in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(ids_p, ids_j)
        # 9-decimal text: two roundings of values that agree to ~1e-13
        np.testing.assert_allclose(fd_p.factors, fd_j.factors, rtol=0,
                                   atol=2e-9)


def test_cli_rejects_multi_device_and_unknown_metric(text_data):
    """--n_devices=0 (every device) has no meaning on the CPU, and more
    cards than the machine has are refused, as qmf_tpu's make_mesh refuses
    them; N ranks on the CPU run (tests/test_torch_parallel.py)."""
    train_p, _ = text_data
    with pytest.raises(ValueError, match="CPU has no device count"):
        port_cli.main([f"--train_dataset={train_p}", "--n_devices=0",
                       "--device=cpu"])
    with pytest.raises(ValueError, match="requested 999 devices"):
        port_cli.main([f"--train_dataset={train_p}", "--n_devices=999",
                       "--device=cuda"])
    assert port_cli.main([f"--train_dataset={train_p}", "--device=cpu",
                          "--test_avg_metrics=bogus"]) == 1


def test_port_imports_no_jax():
    """Importing every module of the port (and the chip smoke script)
    leaves jax out of sys.modules."""
    code = (
        "import sys, pkgutil, importlib, qmf_tpu_torch\n"
        "for m in pkgutil.walk_packages(qmf_tpu_torch.__path__, "
        "'qmf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import qmf_tpu_torch.cli.wals, qmf_tpu_torch.cli.recommend\n"
        "import qmf_tpu_torch.cli.gen_uniform, chip_smoke\n"
        "import qmf_tpu_torch.tools.gather_micro\n"
        "import qmf_tpu_torch.tools.vmem_gather_micro\n"
        "import qmf_tpu_torch.ops.gather, qmf_tpu_torch.ops.bpr_ops\n"
        "import qmf_tpu_torch.models.recommend\n"
        "import qmf_tpu_torch.models.bpr, qmf_tpu_torch.cli.bpr\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('qmf_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 38


def test_port_imports_nothing_of_qmf_tpu():
    """Importing every module of the port and chip_smoke leaves no qmf_tpu
    module, not the root bench.py and nothing of benchmarks/ in
    sys.modules, and no .py file of the port has an import of any of them:
    the port keeps its own copies of the host layer, of the bench's
    protocol (tools/bench.py) and of the data generator
    (tools/datagen.py)."""
    import ast

    code = (
        "import sys, pkgutil, importlib, qmf_tpu_torch\n"
        "for m in pkgutil.walk_packages(qmf_tpu_torch.__path__, "
        "'qmf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import qmf_tpu_torch.models.bpr, qmf_tpu_torch.cli.bpr\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('qmf_tpu', 'bench', "
        "'benchmarks') or m.startswith(('qmf_tpu.', 'benchmarks.')))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

    def imports_qmf_tpu(node):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            mods = [node.module or ""]
        else:
            return False
        return any(m in ("qmf_tpu", "bench", "benchmarks")
                   or m.startswith(("qmf_tpu.", "benchmarks."))
                   for m in mods)

    pkg = os.path.join(REPO, "qmf_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")]
    assert len(files) >= 40
    for new in ("ops/gather.py", "ops/bpr_ops.py", "models/recommend.py",
                "cli/recommend.py", "cli/gen_uniform.py", "models/bpr.py",
                "cli/bpr.py",
                "data/gen_uniform.py", "tools/gather_micro.py",
                "tools/vmem_gather_micro.py", "distributed/protocol.py",
                "distributed/taskdef.py", "distributed/worker.py",
                "distributed/scheduler.py", "distributed/labor.py",
                "distributed/submit.py", "cli/wals_scheduler.py",
                "cli/wals_labor.py", "cli/wals_submit.py",
                "utils/tracing.py", "data/native.py", "ops/device_pack.py",
                "tools/bench.py", "tools/epoch_decomp.py",
                "tools/datagen.py", "tools/bpr_decomp.py",
                "tools/build_attrib.py", "tools/bpr_grouped_micro.py",
                "tools/timing.py", "tools/recovery_cost.py"):
        assert os.path.join(pkg, new) in files
    bad = []
    for path in files + [os.path.join(REPO, "chip_smoke.py")]:
        with open(path) as f:
            tree = ast.parse(f.read())
        bad += [f"{path}:{n.lineno}" for n in ast.walk(tree)
                if imports_qmf_tpu(n)]
    assert not bad, bad


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py names the port's modules, never the JAX package's:
    the data formats reach it through the port's own qmf_tpu_torch.data."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module]
    assert "qmf_tpu_torch.data" in names
    bad = [m for m in names if m.split(".")[0] in ("qmf_tpu", "jax")]
    assert not bad, bad
