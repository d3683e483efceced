"""Multi-device training of the port (qmf_tpu_torch/parallel) on gloo CPU
ranks, against qmf_tpu's single-device engines and the port's own.

Each world size runs one spawned group (``launch.spawn``, under its
deadline) through ``dryrun.run_jobs``: WALS in float64 without and with the
hot split, held to qmf_tpu's single-device WALSEngine at rtol 1e-9 and atol
1e-12 (the tolerance qmf_tpu's tests/test_sharded.py holds its own sharded
engine to); the fused solver in float32 against the port's single-device
engine; BPR in float64 on the grouped path and on both legacy streams,
against the port's single-device engine on the same draws within 1e-9; the
padding rows of the factors; and, at two ranks, checkpoints written by
one engine and resumed by the other. The data are qmf_tpu's test data
(tests/test_sharded.py, tests/test_recommend_sharded_bpr.py), with heights
that no world size here divides.
"""

import inspect
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qmf_tpu.config import WALSConfig as JaxWALSConfig
from qmf_tpu.data.dataset import Dataset as JaxDataset, write_dataset
from qmf_tpu.models.wals import WALSEngine as JaxWALSEngine
from qmf_tpu.parallel import make_mesh as jax_make_mesh
from qmf_tpu.parallel import sharded_gramian as jax_sharded_gramian
from qmf_tpu_torch import kernels
from qmf_tpu_torch.cli import bpr as bpr_cli
from qmf_tpu_torch.cli import wals as wals_cli
from qmf_tpu_torch.config import BPRConfig, WALSConfig
from qmf_tpu_torch.data import Dataset, load_factors
from qmf_tpu_torch.models import BPREngine, WALSEngine
from qmf_tpu_torch.parallel import (
    Mesh,
    ShardedBPREngine,
    ShardedWALSEngine,
    launch,
    make_mesh,
    pad_rows,
)
from qmf_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
    read_result,
    run_jobs,
    write_ratings_npz,
)

torch.set_num_threads(1)

F64 = dict(rtol=1e-9, atol=1e-12)
# fuse_epoch=False: one progress_cb a epoch, as the JAX runs here
WALS = dict(nepochs=2, nfactors=5, regularization_lambda=0.07,
            confidence_weight=20.0, init_seed=1, batch_rows=16,
            fuse_epoch=False)
# f64 WALS runs: hot_width 0 and 4
WALS_RUNS = {"wals": 0, "wals_hot": 4}
# f64 BPR runs: the grouped path (batch 64), the in-step legacy stream
# (batch 75, not a power of two) and the packed legacy stream
BPR = dict(nepochs=3, nfactors=4, init_seed=1, dtype="float64")
BPR_RUNS = {"bpr_grouped": dict(batch_size=64),
            "bpr_instep": dict(batch_size=75),
            "bpr_packed": dict(batch_size=64, grouped_epoch=False)}
# the fused solver in float32, "highest": held at the 1e-5 of
# tests/test_torch_hot.py's fused-vs-qmf_tpu check, scaled by max |x|
FUSED = dict(WALS, solver="fused", hot_width=4)
FUSED_TOL = 1e-5


def _wals_dataset(seed=0, n_users=61, n_items=37, per_user=9):
    """qmf_tpu's tests/test_sharded.py generator, at heights 2 and 4 do not
    divide."""
    rng = np.random.default_rng(seed)
    users, items, vals = [], [], []
    for u in range(n_users):
        for i in rng.choice(n_items, size=per_user, replace=False):
            users.append(u + 10)
            items.append(i + 20)
            vals.append(float(rng.integers(1, 6)))
    return Dataset(np.array(users), np.array(items), np.array(vals))


def _bpr_dataset():
    """qmf_tpu's tests/test_recommend_sharded_bpr.py data."""
    rng = np.random.default_rng(0)
    return Dataset(rng.integers(1, 60, 800), rng.integers(1, 40, 800),
                   np.ones(800))


def _jax(ds):
    return JaxDataset(ds.user_ids, ds.item_ids, ds.values)


def _port_wals(ds, ckpt=None, **kw):
    eng = WALSEngine(WALSConfig(**{**WALS, "dtype": "float64", **kw}),
                     device="cpu")
    losses = []
    eng.progress_cb = lambda e, loss, dt: losses.append(loss)
    if ckpt:
        eng.enable_checkpointing(ckpt)
    eng.init(ds)
    eng.optimize()
    return eng, losses


def _port_bpr(ds, **kw):
    eng = BPREngine(BPRConfig(**{**BPR, **kw}), device="cpu")
    eng.init(ds)
    eng.optimize()
    return eng


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_data")
    wals, bpr = _wals_dataset(), _bpr_dataset()
    paths = {"wals": str(tmp / "wals.npz"), "bpr": str(tmp / "bpr.npz")}
    write_ratings_npz(paths["wals"], wals)
    write_ratings_npz(paths["bpr"], bpr)
    return {"wals": wals, "bpr": bpr, "paths": paths}


@pytest.fixture(scope="module")
def jax_wals(data):
    """qmf_tpu's single-device f64 WALSEngine: per-epoch losses and
    factors, without and with the hot split."""
    out = {}
    for name, hot in WALS_RUNS.items():
        eng = JaxWALSEngine(JaxWALSConfig(
            **WALS, dtype="float64", solver="lu", hot_width=hot))
        losses = []
        eng.progress_cb = lambda e, loss, dt: losses.append(loss)
        eng.init(_jax(data["wals"]))
        eng.optimize()
        out[name] = (losses, np.asarray(eng.user_factors),
                     np.asarray(eng.item_factors))
    return out


def _jobs(data, tmp, world):
    p = data["paths"]
    jobs = [{"engine": "wals", "train": p["wals"], "out": str(tmp / name),
             "config": {**WALS, "dtype": "float64", "hot_width": hot}}
            for name, hot in WALS_RUNS.items()]
    jobs.append({"engine": "wals", "train": p["wals"],
                 "out": str(tmp / "fused"), "config": FUSED})
    # device_pack forced: the ranks still pack on the host
    jobs.append({"engine": "wals", "train": p["wals"],
                 "out": str(tmp / "wals_dp"),
                 "config": {**WALS, "dtype": "float64", "device_pack": True}})
    jobs += [{"engine": "bpr", "train": p["bpr"], "out": str(tmp / name),
              "config": {**BPR, **kw}} for name, kw in BPR_RUNS.items()]
    if world == 2:
        # sharded writes epoch 1 of ckpt_a; sharded resumes epoch 2 from
        # ckpt_b, which a single-device engine wrote before the spawn
        jobs += [
            {"engine": "wals", "train": p["wals"], "out": str(tmp / "ck_a"),
             "checkpoint": str(tmp / "ckpt_a"),
             "config": {**WALS, "dtype": "float64", "nepochs": 1}},
            {"engine": "wals", "train": p["wals"], "out": str(tmp / "ck_b"),
             "checkpoint": str(tmp / "ckpt_b"),
             "config": {**WALS, "dtype": "float64"}},
        ]
    return jobs


def _spawn_group(world, data, tmp_path_factory):
    """One spawned group of ``world`` gloo CPU ranks running every job:
    (world, its directory, {job name: rank 0's results})."""
    tmp = tmp_path_factory.mktemp(f"parallel_w{world}")
    if world == 2:
        _port_wals(data["wals"], ckpt=str(tmp / "ckpt_b"), nepochs=1)
    jobs = _jobs(data, tmp, world)
    launch.spawn(run_jobs, world, device="cpu", args=(jobs,), deadline_s=240)
    return world, tmp, {os.path.basename(job["out"]): read_result(job["out"])
                        for job in jobs}


@pytest.fixture(scope="module")
def sharded2(data, tmp_path_factory):
    return _spawn_group(2, data, tmp_path_factory)


@pytest.fixture(scope="module")
def sharded4(data, tmp_path_factory):
    return _spawn_group(4, data, tmp_path_factory)


@pytest.fixture(params=[2, 4], ids=["w2", "w4"])
def sharded(request):
    return request.getfixturevalue(f"sharded{request.param}")


def test_make_mesh_refuses_too_many_devices():
    with pytest.raises(ValueError, match="requested 1000 devices, only 1 "
                                         "available"):
        make_mesh(1000, device="cpu")
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)


def test_multihost_without_a_coordinator_is_a_world_of_one(monkeypatch):
    """No coordinator and no torchrun environment: initialize joins nothing,
    this process is the coordinator, and the global mesh is one rank."""
    from qmf_tpu_torch.parallel import multihost

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    multihost.initialize()
    assert multihost.is_coordinator()
    mesh = multihost.global_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)


def test_spawn_defaults_to_the_card_and_every_caller_names_its_device():
    """launch.spawn, an entry point, runs its ranks on the card unless the
    caller asks for the CPU; every call of it in the package, chip_smoke.py
    and the tests passes its own device."""
    import ast

    assert inspect.signature(launch.spawn).parameters["device"].default \
        == "cuda"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(repo, "chip_smoke.py")] + [
        os.path.join(d, f)
        for top in ("qmf_tpu_torch", "tests")
        for d, _, fs in os.walk(os.path.join(repo, top)) for f in fs
        if f.endswith(".py") and (top == "qmf_tpu_torch"
                                  or f.startswith("test_torch_"))]
    calls = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        calls += [(path, node) for node in ast.walk(tree)
                  if isinstance(node, ast.Call) and (
                      getattr(node.func, "attr", None) == "spawn"
                      or getattr(node.func, "id", None) == "spawn")
                  and not (isinstance(node.func, ast.Attribute)
                           and getattr(node.func.value, "id", "") == "mp")]
    assert len(calls) >= 8
    missing = [f"{path}:{node.lineno}" for path, node in calls
               if not any(kw.arg in ("device", None)
                          for kw in node.keywords)]
    assert not missing, missing


def test_kernel_launches_run_under_their_tensors_device():
    """Every launch wrapper and device query of kernels.py makes its
    tensor's device current around the library call."""
    for fn, arg in ((kernels.launch_chol_solve, "a.device"),
                    (kernels.launch_chol_solve_t, "a_t.device"),
                    (kernels.launch_build_solve, "yg.device"),
                    (kernels.launch_gather, "table.device"),
                    (kernels.reset_l2_persistence, "device"),
                    (kernels.sm_count.__wrapped__, "device")):
        assert f"with torch.cuda.device({arg}):" in inspect.getsource(fn)


def test_sharded_buckets_send_padding_rows_to_the_sink(data):
    """Padding rows of every class carry the sink id, one past the padded
    height, never a row in [n, pad_rows(n)); every class and chunk splits
    evenly, and the ranks' blocks of a class make up the whole class."""
    for world in (2, 4):
        engines = []
        for rank in range(world):
            eng = ShardedWALSEngine(
                WALSConfig(**WALS, dtype="float64"),
                mesh=Mesh(world, rank, torch.device("cpu")))
            eng.init(data["wals"])
            engines.append(eng)
        eng = engines[0]
        for side, n in (("user", eng.nusers), ("item", eng.nitems)):
            pad = pad_rows(n, eng.mesh)
            assert pad > n  # the data leave padding rows at both widths
            assert getattr(eng, f"{side}_factors").shape[0] == pad
            classes = getattr(eng, f"_{side}_classes")
            chunks = getattr(eng, f"_{side}_chunks")
            sinks = 0
            for c, (rows, *_) in enumerate(classes):
                assert rows.shape[0] % (8 * world) == 0
                assert rows.shape[0] % (chunks[c] * world) == 0
                assert bool(((rows < n) | (rows == pad)).all())
                sinks += int((rows == pad).sum())
                blocks = [getattr(e, f"_{side}_classes")[c][1]
                          for e in engines]
                assert sum(b.shape[0] for b in blocks) == rows.shape[0]
            assert sinks > 0


def test_iterate_side_sharded_in_a_world_of_one_is_the_half_epoch(data):
    """A world of one (no process group) solves the user half-epoch as the
    single-device engine does, bit for bit, its padding rows in the sink."""
    from qmf_tpu_torch.data import IdIndex
    from qmf_tpu_torch.ops import als_ops
    from qmf_tpu_torch.ops.packing import pack_width_classes
    from qmf_tpu_torch.parallel import ShardedBuckets, iterate_side_sharded

    ds = data["wals"]
    single = WALSEngine(WALSConfig(**WALS, dtype="float64"), device="cpu")
    single.init(ds)
    _, rows = IdIndex.from_sorted_ids_with_lookup(ds.user_ids)
    _, cols = IdIndex.from_sorted_ids_with_lookup(ds.item_ids)
    classes = pack_width_classes(rows, cols, ds.values, single.nusers,
                                 WALS["batch_rows"], width_grid="pow2_15")
    mesh = make_mesh(device="cpu")
    buckets = ShardedBuckets(classes, mesh, torch.float64, single.nusers)
    cfg = single.config
    got, loss = iterate_side_sharded(
        single.item_factors, buckets, single._user_chunks, single.nusers,
        cfg.confidence_weight, cfg.regularization_lambda, mesh)
    want, want_loss = als_ops._solve_side(
        single.item_factors, single._user_classes, single._user_chunks,
        single.nusers, cfg.confidence_weight, cfg.regularization_lambda,
        "cholesky", "highest")
    assert torch.equal(got, want) and torch.equal(loss, want_loss)


def test_sharded_wals_keeps_the_host_pack_across_ranks(sharded):
    """A world of several ranks packs on the host even with device_pack
    forced (qmf_tpu's multi-process engine does the same), and trains as
    the run that left it at "auto", to the bit."""
    _, _, res = sharded
    assert str(res["wals_dp"]["pack_kind"]) == "host-packed"
    assert str(res["wals"]["pack_kind"]) == "host-packed"
    for key in ("user_factors", "item_factors", "losses"):
        np.testing.assert_array_equal(res["wals_dp"][key], res["wals"][key])


@pytest.mark.parametrize("name", list(WALS_RUNS))
def test_sharded_wals_f64_matches_jax_single_device(sharded, jax_wals, name):
    world, _, res = sharded
    losses, u, v = jax_wals[name]
    got = res[name]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-9)
    np.testing.assert_allclose(got["user_factors"], u, **F64)
    np.testing.assert_allclose(got["item_factors"], v, **F64)
    # one all_gather a class, one all_reduce for the Gramian and one for the
    # loss, per half-epoch
    assert got["collective_calls"] > 0
    assert str(got["solver"]) == "cholesky"


@pytest.mark.parametrize("name", list(WALS_RUNS))
def test_padding_rows_stay_zero_and_leave_the_gramian(sharded, name):
    """Rows n..pad_rows(n)-1 of both padded factor matrices are exactly
    zero after training, and sharded_gramian of the padded matrix is the
    unpadded YtY, as numpy and qmf_tpu's sharded_gramian on its virtual
    8-device mesh compute it."""
    world, _, res = sharded
    got = res[name]
    for side in ("user", "item"):
        tail = got[f"{side}_pad_rows"]
        assert tail.shape[0] == (-got[f"{side}_factors"].shape[0]) % world
        assert tail.shape[0] > 0 and not tail.any()
        y = got[f"{side}_factors"]
        np.testing.assert_allclose(got[f"gram_{side}"], y.T @ y, rtol=1e-10)
        jax_g = jax_sharded_gramian(jnp.asarray(y), jax_make_mesh(8))
        np.testing.assert_allclose(got[f"gram_{side}"], np.asarray(jax_g),
                                   rtol=1e-10)


def test_sharded_fused_f32_matches_single_device(sharded, data):
    _, _, res = sharded
    single = WALSEngine(WALSConfig(**FUSED), device="cpu")
    losses = []
    single.progress_cb = lambda e, loss, dt: losses.append(loss)
    single.init(data["wals"])
    single.optimize()
    got = res["fused"]
    np.testing.assert_allclose(got["losses"], losses, rtol=FUSED_TOL)
    for side in ("user", "item"):
        want = getattr(single, f"{side}_factors").numpy()
        np.testing.assert_allclose(got[f"{side}_factors"], want, rtol=0,
                                   atol=FUSED_TOL * np.abs(want).max())


@pytest.mark.parametrize("name", list(BPR_RUNS))
def test_sharded_bpr_f64_matches_single_device(sharded, data, name):
    world, _, res = sharded
    single = _port_bpr(data["bpr"], **BPR_RUNS[name])
    got = res[name]
    assert bool(got["grouped"]) == single._grouped == (name == "bpr_grouped")
    for key, want in zip(("user_factors", "item_factors", "item_biases"),
                         single.params):
        np.testing.assert_allclose(got[key], want.numpy(), **F64)
    # ranks hold equal parameters
    other = read_result(str(sharded[1] / name), rank=world - 1)
    for key in ("user_factors", "item_factors", "item_biases"):
        np.testing.assert_array_equal(other[key], got[key])


@pytest.mark.parametrize("world", [2, 4])
def test_grouped_batch_that_ranks_do_not_divide_takes_legacy(data, world):
    """A grouped batch of 2 does not split over 4 ranks: that engine takes
    the legacy stream, padded to a multiple of batch_size x world size,
    where the single-device engine and 2 ranks keep the grouped path (init
    runs no collective, so one rank's engine shows it)."""
    cfg = BPRConfig(**{**BPR, "batch_size": 2})
    single = BPREngine(cfg, device="cpu")
    single.init(data["bpr"])
    eng = ShardedBPREngine(cfg, mesh=Mesh(world, 0, torch.device("cpu")))
    eng.init(data["bpr"])
    assert single._grouped and eng._grouped == (world == 2)
    if world == 4:
        assert eng._tri_users.shape[0] % (2 * world) == 0
        assert eng._tri_weights.shape[0] == eng._tri_users.shape[0]


def test_checkpoints_resume_across_one_and_two_ranks(sharded2, data):
    """Two ranks write epoch 1 and one device resumes; one device writes
    epoch 1 and two ranks resume: both end where an uninterrupted
    single-device run ends."""
    _, tmp, res = sharded2
    straight, _ = _port_wals(data["wals"])
    resumed, losses = _port_wals(data["wals"], ckpt=str(tmp / "ckpt_a"))
    assert len(losses) == 1  # epoch 2 only
    for got in ({"user_factors": resumed.user_factors.numpy(),
                 "item_factors": resumed.item_factors.numpy()},
                res["ck_b"]):
        for key in ("user_factors", "item_factors"):
            np.testing.assert_allclose(
                got[key], getattr(straight, key).numpy(), **F64)
    assert len(res["ck_b"]["losses"]) == 1


def test_dryrun_multichip_two_ranks(capsys):
    dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip OK on 2 cpu ranks (gloo)" in \
        capsys.readouterr().out


@pytest.mark.parametrize("call", ["function", "cli"])
def test_dryrun_multichip_refuses_cuda_without_the_cards(call):
    """A bare "cuda" with fewer cards than ranks raises with the reason
    (NCCL takes one card a rank) instead of moving to the CPU."""
    from qmf_tpu_torch.parallel import dryrun

    with pytest.raises(RuntimeError, match="NCCL takes one card a rank"):
        if call == "function":
            dryrun_multichip(2, device="cuda")
        else:
            dryrun.main(["2"])


@pytest.fixture(scope="module")
def text_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_cli")
    for name, ds in (("wals", _wals_dataset()), ("bpr", _bpr_dataset())):
        write_dataset(_jax(ds), str(tmp / f"{name}.txt"))
    return tmp


@pytest.mark.parametrize("cli,extra", [
    (wals_cli, ["--nfactors=4", "--nepochs=2"]),
    (bpr_cli, ["--nfactors=4", "--nepochs=2", "--batch_size=64"]),
], ids=["wals", "bpr"])
def test_cli_two_cpu_ranks_write_the_one_device_files(text_data, cli, extra):
    name = cli.__name__.rsplit(".", 1)[-1]
    files = {}
    for n in (1, 2):
        u, i = text_data / f"{name}{n}_u.dat", text_data / f"{name}{n}_i.dat"
        assert cli.main([f"--train_dataset={text_data / (name + '.txt')}",
                         "--dtype=float64", "--device=cpu", f"--n_devices={n}",
                         f"--user_factors={u}", f"--item_factors={i}",
                         *extra]) == 0
        files[n] = [load_factors(str(p)) for p in (u, i)]
    for (ids2, fd2), (ids1, fd1) in zip(files[2], files[1]):
        np.testing.assert_array_equal(ids2, ids1)
        # 9-decimal text of values that agree to ~1e-13
        np.testing.assert_allclose(fd2.factors, fd1.factors, rtol=0,
                                   atol=2e-9)
    with pytest.raises(ValueError, match="CPU has no device count"):
        cli.main([f"--train_dataset={text_data / (name + '.txt')}",
                  "--device=cpu", "--n_devices=0"])


def test_collective_probe_runs_on_one_cpu_rank(capsys):
    """tools.collective_micro at world 1 over gloo: one JSON line with each
    shape's three variants, and the process group gone afterwards."""
    import json

    import torch.distributed as dist

    from qmf_tpu_torch.tools import collective_micro

    assert collective_micro.main(["--device=cpu", "--calls=2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["backend"] == "gloo" and line["clock"] == "host (cpu)"
    for name in collective_micro.SHAPES:
        assert {f"{v}_{w}" for v in ("mesh", "raw", "copy")
                for w in ("host_us", "device_us")} == set(line[name])
    assert not dist.is_initialized()
