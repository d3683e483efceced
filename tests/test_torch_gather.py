"""The port's row gather against the JAX gather probes, on the CPU, bit for bit.

Seeded numpy inputs go through the probes under ``benchmarks/`` (their
Pallas kernels in interpret mode) and through ``ops.gather``, whose wrapper
runs its plain version on CPU tensors. ``pallas_take`` and both kernels of
``vmem_gather_micro`` compute table[idx] on every row. ``pallas_gather`` as
written gathers its first block of indices in every grid step, so it is
held to the port on that block only, and the port to the probe's own
reference ``table[idx]`` on all rows; one test pins the repeat.
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from qmf_tpu_torch.ops import gather
from qmf_tpu_torch.tools import gather_micro as port_micro
from qmf_tpu_torch.tools import vmem_gather_micro as port_vmem

BENCHMARKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")
TABLE_ROWS, K, N_IDX = 500, 64, 1024


@pytest.fixture(scope="module")
def probes():
    """(gather_micro, vmem_gather_micro) of benchmarks/, imported by the
    names they have there."""
    sys.path.insert(0, BENCHMARKS)
    try:
        return (importlib.import_module("gather_micro"),
                importlib.import_module("vmem_gather_micro"))
    finally:
        sys.path.remove(BENCHMARKS)


def _inputs(rows=TABLE_ROWS, n=N_IDX, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 0.1, (rows, K)).astype(np.float32)
    return table, rng.integers(0, rows, n).astype(np.int32)


def _bits(x):
    """int16 bit patterns of a bf16 array of either framework."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _port(table, idx, **kw):
    return gather.gather_rows(torch.from_numpy(table).to(torch.bfloat16),
                              torch.from_numpy(idx), **kw)


VARIANTS = ["vec", "warp", "tile"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_pallas_take_matches(probes, variant):
    table, idx = _inputs()
    with pltpu.force_tpu_interpret_mode():
        want = probes[0].pallas_take(jnp.asarray(table).astype(jnp.bfloat16),
                                     jnp.asarray(idx))
    got = _port(table, idx, variant=variant)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert torch.equal(got, gather.gather_rows_plain(
        torch.from_numpy(table).to(torch.bfloat16), torch.from_numpy(idx)))


def test_pallas_gather_first_block_and_its_reference(probes):
    table, idx = _inputs()
    yb = jnp.asarray(table).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        probe = _bits(probes[0].pallas_gather(yb, jnp.asarray(idx), tb=256))
    got = _bits(_port(table, idx))
    np.testing.assert_array_equal(got[:256], probe[:256])
    # the probe's own check compares against yb[idx] (gather_micro.py:170)
    np.testing.assert_array_equal(got, _bits(yb[jnp.asarray(idx)]))


def test_pallas_gather_repeats_its_first_block(probes):
    """The probe reads idx[t] for t < tb in every grid step, with no offset
    by the step: blocks 1.. repeat block 0. The port computes the gather
    the probe's docstring states, so it differs there."""
    table, idx = _inputs()
    with pltpu.force_tpu_interpret_mode():
        probe = _bits(probes[0].pallas_gather(
            jnp.asarray(table).astype(jnp.bfloat16), jnp.asarray(idx),
            tb=256))
    for block in range(1, N_IDX // 256):
        np.testing.assert_array_equal(probe[256 * block:256 * (block + 1)],
                                      probe[:256])
    assert not np.array_equal(probe, _bits(_port(table, idx)))


@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("kernel", ["_take_kernel", "_loop_kernel"])
def test_vmem_probe_matches(probes, kernel, fill):
    vmem = probes[1]
    table, idx = _inputs(rows=vmem.TABLE_ROWS, n=2 * vmem.BLOCK, seed=1)
    run = vmem._make(getattr(vmem, kernel), interpret=True)
    want = run(jnp.asarray(idx), jnp.asarray(table).astype(jnp.bfloat16))
    np.testing.assert_array_equal(_bits(_port(table, idx, fill=fill)),
                                  _bits(want))


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, "bfloat16"])
def test_fill_matches_jnp_take(dtype, idx_dtype):
    """Negative indices wrap once; what is still outside gives zero rows."""
    rows = 11
    rng = np.random.default_rng(2)
    table = rng.normal(size=(rows, 5)).astype(
        np.float32 if dtype == "bfloat16" else dtype)
    idx = np.concatenate([np.arange(-rows - 3, rows + 3),
                          rng.integers(-rows - 3, rows + 3, 40)]
                         ).astype(idx_dtype).reshape(2, -1)
    t, j = torch.from_numpy(table), jnp.asarray(table)
    if dtype == "bfloat16":
        t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    got = gather.gather_rows(t, torch.from_numpy(idx), fill=True)
    want = jnp.take(j, jnp.asarray(idx), axis=0, fill_value=0)
    assert got.shape == (*idx.shape, 5) == want.shape
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dead = (idx < -rows) | (idx >= rows)
    assert dead.any() and not got[torch.from_numpy(dead)].any()
    np.testing.assert_array_equal(
        jnp.take(jnp.arange(5.0), jnp.asarray([-1, -6, 5, 2]), fill_value=0),
        [4.0, 0.0, 0.0, 2.0])


def test_vmem_take_probe_fills_like_the_port(probes):
    """_take_kernel's jnp.take(..., fill_value=0) on out-of-range indices,
    through the probe itself."""
    vmem = probes[1]
    table, idx = _inputs(rows=vmem.TABLE_ROWS, n=vmem.BLOCK, seed=3)
    idx[:6] = [-1, -vmem.TABLE_ROWS, -vmem.TABLE_ROWS - 1, vmem.TABLE_ROWS,
               vmem.TABLE_ROWS + 7, 0]
    run = vmem._make(vmem._take_kernel, interpret=True)
    want = _bits(run(jnp.asarray(idx), jnp.asarray(table).astype(jnp.bfloat16)))
    got = _port(table, idx, fill=True)
    np.testing.assert_array_equal(_bits(got), want)
    assert not got[[2, 3, 4]].any() and got[[0, 1, 5]].any(dim=1).all()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 4), (0,), (4, 0)])
def test_result_shape_follows_idx(shape, variant):
    table, _ = _inputs()
    idx = np.random.default_rng(4).integers(0, TABLE_ROWS, shape)
    got = gather.gather_rows(torch.from_numpy(table), torch.from_numpy(idx),
                             variant)
    assert got.shape == (*shape, K)
    np.testing.assert_array_equal(got.numpy(), table[idx])
    np.testing.assert_array_equal(
        gather.gather_rows_plain(torch.from_numpy(table),
                                 torch.from_numpy(idx)).numpy(), table[idx])


@pytest.mark.parametrize("call,match", [
    (lambda t, i: gather.gather_rows(t, i, variant="block"), "variant"),
    (lambda t, i: gather.gather_rows(t, i, variant="warp", fill=True), "fill"),
    (lambda t, i: gather.gather_rows(t, i, variant="tile", fill=True), "fill"),
    (lambda t, i: gather.gather_rows(t[0], i), "table"),
    (lambda t, i: gather.gather_rows(t.to(torch.float16), i), "bfloat16"),
    (lambda t, i: gather.gather_rows(t, i.to(torch.int16)), "int32 or int64"),
])
def test_wrapper_rejects(call, match):
    table, idx = _inputs()
    with pytest.raises(ValueError, match=match):
        call(torch.from_numpy(table), torch.from_numpy(idx))
    assert gather.launches == {"vec": 0, "warp": 0, "tile": 0,
                               "fill": 0}  # CPU calls


# (row bytes, table pointer, out pointer) -> width for "vec" and "warp":
# the widest vector that divides all three; "warp" the widest that still
# gives 32 lanes a piece, else the narrowest.
@pytest.mark.parametrize("row_bytes,table_ptr,out_ptr,vec,warp", [
    (128, 0x1000, 0x2000, 16, 4),  # k = 64 bf16: 8 lanes a row; 4 B pieces
    (120, 0x1000, 0x2000, 8, 2),  # k = 30 f32
    (128, 0x1002, 0x2000, 2, 2),  # a view one bf16 element into its storage
    (128, 0x1004, 0x2000, 4, 4),  # one f32 element in
    (1024, 0x1000, 0x2000, 16, 16),  # k = 128 f64: 64 vectors a row
    (2, 0x1000, 0x2000, 2, 2),  # k = 1 bf16
    (260, 0x1000, 0x2008, 4, 4),  # k = 65 f32
    (24, 0x1000, 0x2000, 8, 2),  # k = 3 f64
])
def test_vector_bytes(row_bytes, table_ptr, out_ptr, vec, warp):
    assert gather.vector_bytes(row_bytes, table_ptr, out_ptr, "vec") == vec
    assert gather.vector_bytes(row_bytes, table_ptr, out_ptr, "warp") == warp
    with pytest.raises(ValueError, match="aligned"):
        gather.vector_bytes(row_bytes, table_ptr + 1, out_ptr)


# (row bytes, table pointer, out pointer) -> (rows a tile, tiles a warp,
# copy width): 4096 bytes a tile, at most 32 rows; two tiles, asynchronous
# 16-byte copies in and a bulk store out where everything is a multiple of
# 16, else one tile and lane copies of the widest width that fits.
@pytest.mark.parametrize("row_bytes,table_ptr,out_ptr,want", [
    (128, 0x1000, 0x2000, (32, 2, 16)),  # k = 64 bf16
    (512, 0x1000, 0x2000, (8, 2, 16)),  # k = 64 f64
    (60, 0x1000, 0x2000, (32, 1, 4)),  # k = 30 bf16
    (2, 0x1000, 0x2000, (32, 1, 2)),  # k = 1 bf16
    (128, 0x1002, 0x2000, (32, 1, 2)),  # 2 bytes off a boundary
    (128, 0x1000, 0x2008, (32, 1, 8)),  # the output 8 off
    (240, 0x1000, 0x2000, (17, 2, 16)),  # k = 30 f64: 4080 B a tile
    (1024, 0x1000, 0x2000, (4, 2, 16)),  # k = 128 f64
    (8192, 0x1000, 0x2000, (1, 2, 16)),  # a row above a tile
    (130, 0x1000, 0x2000, (31, 1, 2)),  # k = 65 bf16
    (256, 0x1000, 0x2000, (16, 2, 16)),  # k = 64 f32
    (120, 0x1000, 0x2000, (32, 1, 8)),  # k = 30 f32
    (4096, 0x1000, 0x2000, (1, 2, 16)),  # a row that is a tile
    (48, 0x1000, 0x2000, (32, 2, 16)),  # k = 6 f64: 32 rows are 1536 B
])
def test_tile_plan(row_bytes, table_ptr, out_ptr, want):
    assert gather.tile_plan(row_bytes, table_ptr, out_ptr) == want
    with pytest.raises(ValueError, match="aligned"):
        gather.tile_plan(row_bytes, table_ptr + 1, out_ptr)


# The tiles of one warp are all the shared memory the kernel declares, so
# they may fill a block's 232448 bytes to the last one.
@pytest.mark.parametrize("row_bytes,out_ptr,want", [
    (116224, 0, (1, 2, 16)),  # two tiles of one row just fit
    (116240, 0, None),
    (232440, 8, (1, 1, 8)),  # one tile, the widest row of 8-byte copies
    (232456, 8, None),
])
def test_tile_plan_rejects_rows_above_shared_memory(row_bytes, out_ptr, want):
    if want is not None:
        assert gather.tile_plan(row_bytes, 0, out_ptr) == want
        return
    with pytest.raises(ValueError, match="shared memory"):
        gather.tile_plan(row_bytes, 0, out_ptr)


def test_probe_inputs_match_the_originals(probes):
    """The port's probes draw the originals' table and indices: same seed,
    same order of draws (gather_micro.py:116-121, vmem_gather_micro.py
    :103-109)."""
    rng = np.random.default_rng(0)
    y = rng.normal(0, 0.1, (port_micro.N_ITEMS, port_micro.K))
    col = rng.integers(0, port_micro.N_ITEMS, (6, 5))
    port_rng, got_y, got_yb = port_micro.tables(torch.device("cpu"))
    got_col, got_flatp = port_micro.indices(port_rng, 6, 5, torch.device("cpu"))
    np.testing.assert_array_equal(got_y.numpy(), y.astype(np.float32))
    np.testing.assert_array_equal(
        _bits(got_yb), _bits(jnp.asarray(y, jnp.float32).astype(jnp.bfloat16)))
    np.testing.assert_array_equal(got_col.numpy(), col)
    assert got_flatp.shape == (512,) and got_flatp.dtype == torch.int32
    np.testing.assert_array_equal(got_flatp[:30].numpy(), col.ravel())
    assert not got_flatp[30:].any()
    assert (port_micro.N_ITEMS, port_micro.K, port_micro.DEFAULT_SPECS) == (
        probes[0].N_ITEMS, probes[0].K, ((14336, 64), (11520, 256)))

    rng = np.random.default_rng(0)
    idx = rng.integers(0, probes[1].TABLE_ROWS, 1 << 8).astype(np.int32)
    table = rng.normal(0, 0.1, (probes[1].TABLE_ROWS, probes[1].K)).astype(
        np.float32)
    got_table, got_idx = port_vmem.inputs(8, torch.device("cpu"))
    np.testing.assert_array_equal(got_idx.numpy(), idx)
    np.testing.assert_array_equal(
        _bits(got_table), _bits(jnp.asarray(table).astype(jnp.bfloat16)))


@pytest.mark.parametrize("tool,argv", [
    (port_micro, ["40", "8", "--device=cpu"]),
    (port_vmem, ["9", "--device=cpu"]),
])
def test_probe_entry_points_run_on_cpu(capsys, tool, argv):
    """On the CPU the probes time the torch idioms on the host's clock, say
    so, and leave the kernel lines out."""
    assert tool.main(argv) == 0
    out = capsys.readouterr().out
    assert "isel" in out and "[host clock, cpu]" in out
    assert "left out (--device=cpu" in out
    assert "cuda_vec " not in out and "cuda_tile " not in out
    assert "max |diff|" not in out


def test_gather_bounds():
    """The byte counts behind the bounds, at the probes' default shapes."""
    for rows, table_rows, least_mb, ms, every_ms in (
            (14336 * 64, 26744, 124.5, 0.037, 0.071),
            (11520 * 256, 26744, 392.7, 0.117, 0.229),
            (1 << 22, 65536, 562.0, 0.168, 0.326)):
        table = torch.empty((table_rows, 64), dtype=torch.bfloat16)
        idx = torch.empty(rows, dtype=torch.int32)
        bound, every = port_micro.gather_bounds(table, idx)
        assert abs(bound * port_micro.HBM_BPS / 1e9 - least_mb) < 0.06
        assert abs(bound - ms) < 6e-4 and abs(every - every_ms) < 6e-4
