"""Device-side packing of the port (qmf_tpu_torch/ops/device_pack.py) on the
CPU, ``device_pack=True`` forced.

The device pack must give the classes of the port's host pack
(ops/packing.py, as WALSEngine copies them to the device) and of qmf_tpu's
ops/device_pack.py element for element: on qmf_tpu's power-law test data
(tests/test_device_pack.py) with duplicate (row, col) pairs, under every
width grid and class cap, and split hot/cold with rows whose entries are
all hot and with every entry hot. At engine level, a float64 WALSEngine
that packs on the device trains as qmf_tpu's device-packed engine to 1e-9
and as the port's host-packed engine exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qmf_tpu.config import WALSConfig as JaxWALSConfig
from qmf_tpu.data.dataset import Dataset as JaxDataset
from qmf_tpu.models.wals import WALSEngine as JaxWALSEngine
from qmf_tpu.ops import device_pack as jax_dp
from qmf_tpu_torch.config import WALSConfig
from qmf_tpu_torch.data import Dataset
from qmf_tpu_torch.models import WALSEngine
from qmf_tpu_torch.ops import device_pack as dp
from qmf_tpu_torch.ops import hot as hot_ops
from qmf_tpu_torch.ops.packing import chunks_for_classes, pack_width_classes
from qmf_tpu_torch.parallel import Mesh, ShardedWALSEngine

N_ROWS, N_COLS, BATCH = 60, 40, 32
# (width grid, max classes): every grid, uncapped and capped
GRIDS = [("pow2", 0), ("pow2_15", 0), ("pow2_q", 0), ("pow2_15", 3)]


def _power_law_coo(rng, n_rows, n_cols, nnz):
    """qmf_tpu's tests/test_device_pack.py generator: skewed degrees and
    duplicate (row, col) pairs."""
    rows = (rng.pareto(1.3, nnz) * 3).astype(np.int64) % n_rows
    cols = rng.integers(0, n_cols, nnz)
    vals = rng.uniform(0.5, 5.0, nnz)
    return rows, cols, vals


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_classes_equal(got, want_host, dtype=torch.float32):
    """Device-packed Buckets of tensors against host-packed numpy Buckets
    as the engine copies them: int64 ids, values in ``dtype``, bool mask."""
    assert len(got) == len(want_host) > 0
    for g, w in zip(got, want_host):
        for name, want_dtype in (("row_ids", torch.int64),
                                 ("col_idx", torch.int64),
                                 ("values", dtype), ("mask", torch.bool)):
            gt = getattr(g, name)
            assert gt.dtype == want_dtype, name
            assert torch.equal(gt, _t(getattr(w, name)).to(want_dtype)), name


def _assert_classes_equal_jax(got, want_jax):
    assert len(got) == len(want_jax)
    for g, w in zip(got, want_jax):
        for gt, wt in zip((g.row_ids, g.col_idx, g.values, g.mask), w):
            np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


def _jax_coo(rows, cols, vals):
    return (jnp.asarray(rows.astype(np.int32)),
            jnp.asarray(cols.astype(np.int32)),
            jnp.asarray(vals, dtype=jnp.float32))


@pytest.mark.parametrize("grid,max_classes", GRIDS)
@pytest.mark.parametrize("nnz", [50, 5000])
def test_classes_identical_to_host_pack_and_qmf_tpu(nnz, grid, max_classes):
    rows, cols, vals = _power_law_coo(np.random.default_rng(3), N_ROWS,
                                      N_COLS, nnz)
    deg = np.bincount(rows, minlength=N_ROWS)
    kw = dict(batch_rows=BATCH, width_grid=grid, max_classes=max_classes)
    got, plans = dp.pack_width_classes_device(
        _t(rows), _t(cols), _t(vals).float(), N_ROWS, deg, **kw)
    host = pack_width_classes(rows, cols, vals, N_ROWS, **kw)
    _assert_classes_equal(got, host)
    assert [p.chunk_b for p in plans] == chunks_for_classes(host, BATCH) \
        == chunks_for_classes(got, BATCH)
    want, want_plans = jax_dp.pack_width_classes_device(
        *_jax_coo(rows, cols, vals), N_ROWS, deg, **kw)
    _assert_classes_equal_jax(got, want)
    assert dp.plan_stats(plans, nnz) == jax_dp.plan_stats(want_plans, nnz)
    for p, q in zip(plans, want_plans):
        np.testing.assert_array_equal(p.row_ids, q.row_ids)
        assert (p.d_width, p.chunk_b) == (q.d_width, q.chunk_b)


def test_duplicate_pairs_keep_input_order():
    """Duplicate (row, col) pairs with distinct values keep their input
    order (the reference keeps duplicates as separate signals)."""
    rows = np.array([2, 2, 2, 1, 2], dtype=np.int64)
    cols = np.array([5, 5, 5, 0, 1], dtype=np.int64)
    vals = np.array([1.0, 2.0, 3.0, 9.0, 4.0])
    cols_s, vals_s, indptr = dp.sorted_csr(_t(rows), _t(cols), _t(vals), 3)
    assert cols_s.tolist() == [0, 1, 5, 5, 5]
    assert vals_s.tolist() == [9.0, 4.0, 1.0, 2.0, 3.0]
    assert indptr.tolist() == [0, 0, 1, 5]
    got, _ = dp.pack_width_classes_device(
        _t(rows), _t(cols), _t(vals), 3, np.bincount(rows, minlength=3))
    _assert_classes_equal(got, pack_width_classes(rows, cols, vals, 3),
                          torch.float64)


@pytest.mark.parametrize("h", [4, 12, N_COLS])  # N_COLS: every entry hot
@pytest.mark.parametrize("nnz", [50, 5000])
def test_hot_split_identical_to_host_pack_and_qmf_tpu(nnz, h):
    """One sort gives the cold classes of the host pack and qmf_tpu's
    split; rows whose entries are all hot keep a fully masked slot; the
    hot COO is qmf_tpu's, and builds the host pack's hot weights."""
    rows, cols, vals = _power_law_coo(np.random.default_rng(5), N_ROWS,
                                      N_COLS, nnz)
    deg = np.bincount(rows, minlength=N_ROWS)
    hot_ids = hot_ops.top_hot_columns(np.bincount(cols, minlength=N_COLS), h)
    rank = hot_ops.rank_lookup(hot_ids, N_COLS)
    is_hot = rank[cols] < h
    cold_nnz = int((~is_hot).sum())
    cold_deg = np.bincount(rows[~is_hot], minlength=N_ROWS)
    if h == 12:
        assert ((cold_deg == 0) & (deg > 0)).any()  # some rows all hot
    if h == N_COLS:
        assert cold_nnz == 0
    presorted, hot_coo = dp.split_sorted_csr(
        _t(rows), _t(cols), _t(vals).float(), _t(is_hot), N_ROWS, cold_nnz)
    kw = dict(batch_rows=BATCH, width_grid="pow2_15", active_mask=deg > 0)
    got, plans = dp.pack_width_classes_device(
        None, None, _t(vals).float(), N_ROWS, cold_deg, presorted=presorted,
        **kw)
    host = pack_width_classes(rows[~is_hot], cols[~is_hot], vals[~is_hot],
                              N_ROWS, **kw)
    _assert_classes_equal(got, host)

    j_rows, j_cols, j_vals = _jax_coo(rows, cols, vals)
    j_pre, j_hot = jax_dp.split_sorted_csr(
        j_rows, j_cols, j_vals, jnp.asarray(is_hot), N_ROWS, cold_nnz)
    want, _ = jax_dp.pack_width_classes_device(
        j_rows, j_cols, j_vals, N_ROWS, cold_deg, presorted=j_pre, **kw)
    _assert_classes_equal_jax(got, want)
    for g, w in zip(presorted + hot_coo, j_pre + j_hot):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    # the hot COO builds the host pack's hot weights, bit for bit
    row_ids = [p.row_ids for p in plans]
    from_device = hot_ops.build_hot_classes(
        hot_coo[0], _t(rank)[hot_coo[1]], hot_coo[2], row_ids, N_ROWS, h,
        40.0, torch.float32, torch.float32)
    from_host = hot_ops.build_hot_classes(
        rows[is_hot], rank[cols[is_hot]], vals[is_hot].astype(np.float32),
        row_ids, N_ROWS, h, 40.0, torch.float32, torch.float32)
    for gc, wc in zip(from_device, from_host):
        for g, w in zip(gc[:2], wc[:2]):  # W_a, W_b
            assert torch.equal(g, w)
        torch.testing.assert_close(gc[2], wc[2], rtol=1e-6, atol=0)


def test_sort_key_refuses_indices_past_int64():
    big = torch.tensor([1 << 31], dtype=torch.int64)
    with pytest.raises(ValueError, match="too large"):
        dp.sorted_csr(big, torch.zeros(1, dtype=torch.int64),
                      torch.ones(1), (1 << 31) + 1)


def _dataset(seed=7, n=3000):
    rng = np.random.default_rng(seed)
    users = (rng.pareto(1.3, n) * 3).astype(np.int64) % 80 + 10
    items = rng.integers(1, 60, n)
    return Dataset(users, items, rng.integers(1, 6, n).astype(float))


ENGINE = dict(nepochs=3, nfactors=4, init_seed=1, dtype="float64",
              batch_rows=32, regularization_lambda=0.07)


def _train(engine, ds):
    losses = []
    engine.progress_cb = lambda e, loss, dt: losses.append(loss)
    engine.init(ds)
    engine.optimize()
    return losses


@pytest.mark.parametrize("hot_width", [0, 5])
def test_engine_device_pack_matches_qmf_tpu_and_host_pack(hot_width):
    ds = _dataset()
    cfg = dict(ENGINE, hot_width=hot_width)
    dev = WALSEngine(WALSConfig(**cfg, device_pack=True), device="cpu")
    dev_losses = _train(dev, ds)
    host = WALSEngine(WALSConfig(**cfg, device_pack=False), device="cpu")
    host_losses = _train(host, ds)
    assert (dev._pack_kind, host._pack_kind) == ("device-packed",
                                                 "host-packed")
    for side in ("user", "item"):
        assert getattr(dev, f"_{side}_chunks") == \
            getattr(host, f"_{side}_chunks")
        for d, h in zip(getattr(dev, f"_{side}_classes"),
                        getattr(host, f"_{side}_classes"), strict=True):
            assert all(torch.equal(a, b) and a.dtype == b.dtype
                       for a, b in zip(d, h))
    assert torch.equal(dev.user_factors, host.user_factors)
    assert torch.equal(dev.item_factors, host.item_factors)
    np.testing.assert_allclose(dev_losses, host_losses, rtol=1e-12)

    jax = JaxWALSEngine(JaxWALSConfig(
        **cfg, device_pack=True, solver="lu", fuse_epoch=False))
    jax_losses = []
    jax.progress_cb = lambda e, loss, dt: jax_losses.append(loss)
    jax.init(JaxDataset(ds.user_ids, ds.item_ids, ds.values))
    jax.optimize()
    np.testing.assert_allclose(dev_losses, jax_losses, rtol=1e-9)
    for got, want in ((dev.user_factors, jax.user_factors),
                      (dev.item_factors, jax.item_factors)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-9, atol=1e-12)


def test_auto_resolves_as_qmf_tpu():
    """"auto" packs on the device for float32 on a CUDA device only; the
    sharded engine packs on the host at a world of more than one rank."""
    def use(device="cpu", mesh=None, **kw):
        cfg = WALSConfig(**kw)
        if mesh is None:
            return WALSEngine(cfg, device=device)._use_device_pack()
        return ShardedWALSEngine(cfg, mesh=mesh)._use_device_pack()

    assert not use()
    assert not use(dtype="float64")
    assert use(device="cuda")
    assert not use(device="cuda", dtype="float64")
    assert use(device_pack=True) and not use(device="cuda", device_pack=False)
    cuda = torch.device("cuda")
    assert use(mesh=Mesh(1, 0, cuda))
    assert not use(mesh=Mesh(2, 0, cuda))
    assert not use(mesh=Mesh(2, 1, torch.device("cpu")), device_pack=True)
    for bad in ("yes", 1, None):
        with pytest.raises(ValueError, match="device_pack"):
            WALSConfig(device_pack=bad)


def test_sharded_engine_packs_on_the_device_at_world_one():
    """At a world of one the sharded engine takes the device pack's
    tensors and trains as the single-device engine, bit for bit; at two it
    keeps the host pack (tests/test_torch_parallel.py runs that world)."""
    ds = _dataset(seed=3)
    cfg = WALSConfig(**ENGINE, device_pack=True)
    single = WALSEngine(cfg, device="cpu")
    _train(single, ds)
    sharded = ShardedWALSEngine(cfg, mesh=Mesh(1, 0, torch.device("cpu")))
    _train(sharded, ds)
    assert sharded._pack_kind == "device-packed"
    assert torch.equal(sharded.user_factors[: sharded.nusers],
                       single.user_factors)
    assert torch.equal(sharded.item_factors[: sharded.nitems],
                       single.item_factors)
    rank0 = ShardedWALSEngine(cfg, mesh=Mesh(2, 0, torch.device("cpu")))
    rank0.init(ds)
    assert rank0._pack_kind == "host-packed"


def test_init_stages_cover_init():
    """Every stage is timed, and the stages add up to at most init's wall
    time, on either pack."""
    import time

    ds = _dataset(seed=11)
    for device_pack, hot_width in ((True, 0), (False, 0), (True, 5)):
        eng = WALSEngine(WALSConfig(**ENGINE, hot_width=hot_width,
                                    device_pack=device_pack), device="cpu")
        t0 = time.time()
        eng.init(ds)
        wall = time.time() - t0
        stages = eng._init_stages
        assert set(stages) == {"index", "pack_user", "pack_item", "copy",
                               "factors"}
        assert all(v >= 0 for v in stages.values())
        assert sum(stages.values()) <= wall
