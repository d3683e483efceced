"""WALS ``class_solve=False``, the in-scan solve, on the CPU.

- ``class_solve=False`` gives the factors and losses of ``True``
  (``torch.equal``) on the split path, ``kernel`` (its plain version here)
  and ``cholesky``, with and without the hot split, each solve handed one
  chunk's systems rather than a class's;
- it is within 1e-9 of qmf_tpu's ``class_solve=False`` in float64;
- two gloo ranks give one device's factors (within 1e-9, float64) and
  ``True``'s on the same ranks bit for bit;
- ``solver="fused"`` ignores it, as qmf_tpu's does;
- its epoch reads nothing on the host (graphs.NoHostReads);
- ``WALSConfig`` has every field of qmf_tpu's, each with its default.
"""

import dataclasses

import numpy as np
import pytest
import torch

from qmf_tpu.config import WALSConfig as JaxWALSConfig
from qmf_tpu.data.dataset import Dataset as JaxDataset
from qmf_tpu.models.wals import WALSEngine as JaxWALSEngine
from qmf_tpu_torch.config import WALSConfig
from qmf_tpu_torch.data import Dataset
from qmf_tpu_torch.models import WALSEngine
from qmf_tpu_torch.ops import als_ops, graphs
from qmf_tpu_torch.parallel import launch
from qmf_tpu_torch.parallel.dryrun import (read_result, run_jobs,
                                           write_ratings_npz)

CFG = dict(nepochs=3, nfactors=8, batch_rows=16, init_seed=2)


def _dataset(seed=0, n_u=150, n_i=90, nnz=2500):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n_u * n_i, nnz))
    return Dataset(key // n_i + 1, key % n_i + 1,
                   rng.integers(1, 11, len(key)) * 0.5)


def _run(ds, record=None, **kw):
    """An engine trained on ``ds`` eagerly, an epoch at a time (so each
    epoch's loss is logged); ``record`` collects the batch of every solve
    the split path hands its solver."""
    eng = WALSEngine(WALSConfig(**{**CFG, "fuse_epoch": False, **kw}),
                     device="cpu")
    losses = []
    eng.progress_cb = lambda e, loss, dt: losses.append(loss)
    eng.init(ds)
    solve = als_ops._solve_dispatch
    if record is not None:
        als_ops._solve_dispatch = lambda a, b, s: (
            record.append(a.shape[0]), solve(a, b, s))[1]
    try:
        eng.optimize()
    finally:
        als_ops._solve_dispatch = solve
    return eng, losses


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("hot_width", [0, 6])
@pytest.mark.parametrize("solver", ["kernel", "cholesky"])
def test_chunk_solve_equals_class_solve(solver, hot_width, dtype):
    """Every system is solved alone either way: class_solve=False's factors
    and losses are True's bit for bit, while no solve it makes holds more
    than a chunk's rows and it makes one a chunk."""
    ds = _dataset()
    kw = dict(solver=solver, hot_width=hot_width, dtype=dtype)
    chunks, classes = [], []
    split, s_losses = _run(ds, chunks, class_solve=False, **kw)
    whole, w_losses = _run(ds, classes, class_solve=True, **kw)
    assert torch.equal(split.user_factors, whole.user_factors)
    assert torch.equal(split.item_factors, whole.item_factors)
    assert s_losses == w_losses and len(s_losses) == CFG["nepochs"]
    n_chunks = sum(-(-arr[0].shape[0] // c) for side in ("user", "item")
                   for arr, c in zip(getattr(split, f"_{side}_classes"),
                                     getattr(split, f"_{side}_chunks")))
    assert len(chunks) == CFG["nepochs"] * n_chunks > len(classes)
    assert max(chunks) <= max(split._user_chunks + split._item_chunks)
    assert max(classes) > max(chunks)  # some class spans several chunks


@pytest.mark.parametrize("hot_width", [0, 6])
@pytest.mark.parametrize("fuse_epoch", [True, False])
def test_class_solve_false_matches_qmf_tpu(fuse_epoch, hot_width):
    """The port's class_solve=False against qmf_tpu's (its _scan_class, the
    solve inside every scan step), float64: factors within 1e-9."""
    ds = _dataset(1)
    cfg = dict(**CFG, dtype="float64", class_solve=False,
               hot_width=hot_width, fuse_epoch=fuse_epoch)
    jax_eng = JaxWALSEngine(JaxWALSConfig(**cfg, solver="lu"))
    jax_eng.init(JaxDataset(ds.user_ids, ds.item_ids, ds.values))
    jax_eng.optimize()
    eng = WALSEngine(WALSConfig(**cfg), device="cpu")
    eng.init(ds)
    eng.optimize()
    for got, want in ((eng.user_factors, jax_eng.user_factors),
                      (eng.item_factors, jax_eng.item_factors)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                                   atol=1e-9)


@pytest.mark.parametrize("hot_width", [0, 8])
def test_fused_ignores_class_solve(hot_width):
    """solver="fused" builds and solves a chunk at a time either way."""
    ds = _dataset(2)
    runs = [_run(ds, solver="fused", hot_width=hot_width, class_solve=c)
            for c in (True, False)]
    (a, a_losses), (b, b_losses) = runs
    assert torch.equal(a.user_factors, b.user_factors)
    assert torch.equal(a.item_factors, b.item_factors)
    assert a_losses == b_losses


def test_chunk_solved_epoch_reads_nothing_on_the_host():
    """The epoch a card captures, with class_solve=False, under
    graphs.NoHostReads, with and without the hot split."""
    ds = _dataset(3)
    for hot_width in (0, 6):
        eng = WALSEngine(WALSConfig(**CFG, class_solve=False,
                                    hot_width=hot_width), device="cpu")
        eng.init(ds)
        with graphs.NoHostReads():
            u, v, loss = eng._epoch_body()(eng.item_factors)
        assert torch.isfinite(u).all() and torch.isfinite(v).all()


def test_gloo_ranks_class_solve_false(tmp_path):
    """Two gloo CPU ranks of ShardedWALSEngine, float64: each rank solves
    its chunks into its block of the class before the class's one
    all_gather. class_solve=False equals True on the ranks bit for bit,
    and one device's factors within 1e-9; the collective bytes are
    True's."""
    ds = _dataset(4, 61, 37, 700)
    train = str(tmp_path / "train.npz")
    write_ratings_npz(train, ds)
    cfg = dict(CFG, nepochs=2, dtype="float64", batch_rows=8)
    jobs = [{"engine": "wals", "train": train,
             "out": str(tmp_path / f"h{hot}_c{int(cs)}"),
             "config": {**cfg, "hot_width": hot, "class_solve": cs}}
            for hot in (0, 4) for cs in (False, True)]
    launch.spawn(run_jobs, 2, device="cpu", args=(jobs,), deadline_s=240)
    for hot in (0, 4):
        split = read_result(str(tmp_path / f"h{hot}_c0"))
        whole = read_result(str(tmp_path / f"h{hot}_c1"))
        one = WALSEngine(WALSConfig(**cfg, hot_width=hot, class_solve=False),
                         device="cpu")
        one.init(ds)
        one.optimize()
        for key in ("user_factors", "item_factors"):
            np.testing.assert_array_equal(split[key], whole[key])
            np.testing.assert_allclose(
                split[key], getattr(one, key).numpy(), rtol=1e-9, atol=1e-9)
        np.testing.assert_array_equal(split["losses"], whole["losses"])
        assert int(split["collective_all_gather_bytes"]) == int(
            whole["collective_all_gather_bytes"]) > 0


def test_wals_config_has_every_field_of_qmf_tpus():
    """Every field of qmf_tpu's WALSConfig, each with its default."""
    want = {f.name: f.default for f in dataclasses.fields(JaxWALSConfig)}
    got = {f.name: f.default for f in dataclasses.fields(WALSConfig)}
    assert got == want
    assert WALSConfig().class_solve is True
