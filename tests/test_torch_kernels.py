"""The hand-written CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: each test skips unless a CUDA device and nvcc are present
(``qmf_tpu_torch.kernels.available()``). This file imports no jax, so on a
machine without it run it without the repo's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import itertools

import pytest
import torch

from qmf_tpu_torch import kernels
from qmf_tpu_torch.ops import build_solve, gather, spd_solve

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not kernels.available():
        pytest.skip("needs a CUDA device and nvcc (kernels.available() is False)")
    return torch.device("cuda")


def _spd(bsz, k, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    m = torch.randn(bsz, k, k, generator=g, dtype=torch.float64)
    a = m @ m.transpose(1, 2) / k + torch.eye(k, dtype=torch.float64)
    b = torch.randn(bsz, k, generator=g, dtype=torch.float64)
    return a.to(device, dtype), b.to(device, dtype)


_TOL = {torch.float32: 2e-4, torch.float64: 1e-10}


def _check_chol(a, b, layout, tol):
    before = spd_solve.launches
    got = spd_solve.solve_spd(a, b, layout=layout)
    torch.cuda.synchronize()
    assert spd_solve.launches == before + 1
    want = spd_solve.solve_spd_reference(a, b)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("layout", ["nat", "t"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("k", [1, 8, 30, 31, 33, 64, 65, 128, "max"])
def test_kernel_matches_plain(cuda, k, dtype, tol, layout):
    if k == "max":
        k = kernels.chol_solve_max_k(dtype, batch_last=layout == "t")
    a, b = _spd(37, k, dtype, cuda, seed=k)
    _check_chol(a, b, layout, tol)


@pytest.mark.parametrize("layout", ["nat", "t"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [30, 64])
@pytest.mark.parametrize("bsz", [1, "per_block+1", 4097])
def test_kernel_partial_last_block(cuda, bsz, k, dtype, layout):
    """Batches that leave the last block's systems partly unused."""
    per_block = kernels.chol_solve_limits(dtype, k).systems_per_block
    if bsz == "per_block+1":
        bsz = per_block + 1
    a, b = _spd(bsz, k, dtype, cuda, seed=bsz + k)
    _check_chol(a, b, layout, _TOL[dtype])


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 8, 30, 33, 64, 65, "max"])
@pytest.mark.parametrize("bsz", [1, 13, "per_block+1", 131])
def test_cholesky_solve_t_matches_plain(cuda, bsz, k, dtype, resident):
    """The batch-last entry on a resident (k, k, B) buffer, and on a
    batch-first one seen through a permuted view: both read where they lie,
    one launch each, x written batch-last."""
    if k == "max":
        k = kernels.chol_solve_max_k(dtype, batch_last=True)
    if bsz == "per_block+1":
        bsz = kernels.chol_solve_limits(dtype, k).systems_per_block_t + 1
    a, b = _spd(bsz, k, dtype, cuda, seed=bsz + k)
    a_t, b_t = a.permute(1, 2, 0), b.t()
    if resident:
        a_t, b_t = a_t.contiguous(), b_t.contiguous()
    before = (spd_solve.launches, spd_solve.launches_t)
    x_t = spd_solve.cholesky_solve_t(a_t, b_t)
    torch.cuda.synchronize()
    assert (spd_solve.launches, spd_solve.launches_t) == (
        before[0] + 1, before[1] + 1)
    assert x_t.shape == (k, bsz) and x_t.is_contiguous()
    torch.testing.assert_close(x_t.t(), spd_solve.solve_spd_reference(a, b),
                               rtol=_TOL[dtype], atol=_TOL[dtype])


def test_cholesky_solve_t_non_spd_in_a_tail_block(cuda):
    k = 64
    per_block = kernels.chol_solve_limits(
        torch.float32, k).systems_per_block_t
    bsz = per_block + 3
    a, b = _spd(bsz, k, torch.float32, cuda, seed=11)
    bad = [1, per_block + 1]
    a[bad[0], 40, 40] = -5.0
    a[bad[1]] = -a[bad[1]]
    x = spd_solve.cholesky_solve_t(a.permute(1, 2, 0).contiguous(),
                                   b.t().contiguous()).t()
    torch.cuda.synchronize()
    good = [i for i in range(bsz) if i not in bad]
    assert (~torch.isfinite(x).all(dim=1)).nonzero().flatten().tolist() == bad
    torch.testing.assert_close(x[good], spd_solve.solve_spd_reference(
        a[good], b[good]), rtol=2e-4, atol=2e-4)


def test_kernel_non_spd_gives_nan(cuda):
    a, b = _spd(5, 16, torch.float32, cuda)
    a[3] = -a[3]
    x = spd_solve.solve_spd(a, b)
    torch.cuda.synchronize()
    assert torch.isnan(x[3]).all()
    assert torch.isfinite(x[[0, 1, 2, 4]]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_non_spd_rows_share_a_block(cuda, dtype):
    """Non-SPD systems come out NaN, and the SPD systems of their block stay
    finite and right."""
    k = 64
    per_block = kernels.chol_solve_limits(dtype, k).systems_per_block
    assert per_block >= 2
    bsz = 2 * per_block + 3
    a, b = _spd(bsz, k, dtype, cuda, seed=7)
    bad = [1, per_block, per_block + 2, bsz - 1]
    a[bad[0]] = -a[bad[0]]
    a[bad[1], 40, 40] = -5.0  # a negative pivot late in the factor
    a[bad[2]] = 0.0
    a[bad[3], 0, 0] = 0.0  # a zero first pivot
    x = spd_solve.solve_spd(a, b)
    torch.cuda.synchronize()
    good = [i for i in range(bsz) if i not in bad]
    assert (~torch.isfinite(x).all(dim=1)).nonzero().flatten().tolist() == bad
    torch.testing.assert_close(x[good], spd_solve.solve_spd_reference(
        a[good], b[good]), rtol=_TOL[dtype], atol=_TOL[dtype])


@pytest.mark.parametrize("dtype,today", [(torch.float32, 239),
                                         (torch.float64, 169)])
def test_chol_solve_limits(cuda, dtype, today):
    """The library's max k is no lower than the block-per-system kernel's
    (k (k|1) + 2k elements per block), every k up to it has at least one
    system per block, and k = 64 holds several."""
    limits = kernels.chol_solve_limits(dtype)
    assert limits.max_k >= today
    for k in range(1, limits.max_k + 1):
        at_k = kernels.chol_solve_limits(dtype, k)
        assert at_k.max_k == limits.max_k and at_k.systems_per_block >= 1
        assert at_k.systems_per_block * at_k.system_bytes <= kernels.MAX_SMEM_BYTES
    assert kernels.chol_solve_limits(dtype, limits.max_k + 1).systems_per_block == 0
    assert kernels.chol_solve_limits(dtype, 64).systems_per_block >= 2
    # the batch-last entry: b and x in shared memory too, so no larger a k;
    # a multiple of 8 systems wherever 8 fit
    assert limits.max_k - 8 <= limits.max_k_t <= limits.max_k
    for k in range(1, limits.max_k_t + 1):
        at_k = kernels.chol_solve_limits(dtype, k)
        assert at_k.systems_per_block_t >= 1
        assert at_k.system_bytes_t > at_k.system_bytes
        assert (at_k.systems_per_block_t * at_k.system_bytes_t
                <= kernels.MAX_SMEM_BYTES)
        if 8 * at_k.system_bytes_t <= kernels.MAX_SMEM_BYTES:
            assert at_k.systems_per_block_t % 8 == 0
    assert kernels.chol_solve_limits(
        dtype, limits.max_k_t + 1).systems_per_block_t == 0


def test_kernel_rejects_k_over_limit(cuda):
    k = kernels.chol_solve_limits(torch.float64).max_k + 1
    a, b = _spd(1, k, torch.float64, cuda)
    with pytest.raises(ValueError, match="shared-memory limit"):
        spd_solve.solve_spd(a, b)


def _bs_args(n, d, k, h, dtype, device, seed=0):
    """Seeded build_solve arguments: WALS-like weights (40 r on ~80% of the
    slots) over the gathered rows of a random table; for h > 0 a hot head
    observed at ~30% density."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_cols = 4 * k + 64
    y = 0.3 * torch.randn(n_cols, k, generator=g)
    col = torch.randint(0, n_cols, (n, d), generator=g)
    mask = (torch.rand(n, d, generator=g) < 0.8).float()
    w = 20.0 * torch.randint(1, 11, (n, d), generator=g) * mask
    args = [y[col].to(dtype), w, mask + w,
            y.T @ y + 0.05 * torch.eye(k), None, None]
    if h:
        seen = (torch.rand(n, h, generator=g) < 0.3).float()
        w_a = 20.0 * torch.randint(1, 11, (n, h), generator=g) * seen
        args[4] = (w_a.to(dtype), (w_a + seen).to(dtype))
        args[5] = (0.3 * torch.randn(h, k, generator=g)).to(dtype)
    return [None if a is None else
            tuple(t.to(device) for t in a) if isinstance(a, tuple) else
            a.to(device) for a in args]


def _assert_rowwise_close(got, want, tol):
    """|got - want| <= tol * max(1, max |want| of the row), row by row:
    both sum in f32 in different orders."""
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    assert float(((got - want).abs() / scale).max()) <= tol


# (n, d, k, h): the grid of every n x d x k x h; then the D split (few
# rows, wide D: S > 1); then widths no split or 16 divides, split (5 rows)
# and not (700 rows, one block per row), with k = 128 (eight 16-row MMA
# tiles, several 64-wide hot tiles) and H = 1024.
_BS_CASES = [
    *itertools.product((1, 13, 300), (8, 320, 512), (8, 30, 64), (0, 300)),
    *((*nd, k, h) for nd, k, h in itertools.product(
        ((1, 4096), (8, 32768)), (30, 64), (0, 300))),
    *((*nd, k, h) for nd, k, h in itertools.product(
        ((5, 4097), (700, 320), (700, 448)), (8, 30, 64, 128),
        (0, 300, 1024))),
]


@pytest.mark.parametrize("n,d,k,h", _BS_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_build_solve_matches_plain(cuda, dtype, n, d, k, h):
    args = _bs_args(n, d, k, h, dtype, cuda, seed=k + d + n)
    before = (build_solve.launches, build_solve.launches_hot)
    x, b = build_solve.build_solve(*args)
    torch.cuda.synchronize()
    after = (build_solve.launches, build_solve.launches_hot)
    assert after == (before[0] + (h == 0), before[1] + (h > 0))
    x_plain, b_plain = build_solve.build_solve_reference(*args)
    _assert_rowwise_close(b, b_plain, 2e-4)
    _assert_rowwise_close(x, x_plain, 2e-4)


@pytest.mark.parametrize("h", [0, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_build_solve_split_is_deterministic(cuda, dtype, h):
    """A split chunk (partials reduced in slice order, no atomics) gives
    the same bits on every call."""
    n, d = 8, 32768
    assert build_solve.split_count(n, d, kernels.sm_count(cuda)) > 1
    args = _bs_args(n, d, 64, h, dtype, cuda, seed=3)
    first = build_solve.build_solve(*args)
    second = build_solve.build_solve(*args)
    torch.cuda.synchronize()
    for u, v in zip(first, second):
        assert torch.equal(u, v)


def test_build_solve_non_spd_rows_are_nan(cuda):
    args = _bs_args(8, 64, 30, 0, torch.bfloat16, cuda)
    args[1][[2, 5]] = 0.0
    args[2][[2, 5]] = 0.0
    args[3] = -0.05 * torch.eye(30, device=cuda)
    x, _ = build_solve.build_solve(*args)
    torch.cuda.synchronize()
    assert (~torch.isfinite(x).all(dim=1)).tolist() == [
        i in (2, 5) for i in range(8)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_build_solve_rejects_k_over_limit(cuda, dtype):
    k = kernels.build_solve_max_k(dtype) + 1
    args = _bs_args(1, 8, k, 0, dtype, cuda)
    with pytest.raises(ValueError, match="shared-memory limit"):
        build_solve.build_solve(*args)


@pytest.mark.parametrize("h", [0, 300])
@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, (229, 1024, 128, 64)), (torch.float32, (209, 512, 128, 64))])
def test_build_solve_runs_at_its_limits(cuda, dtype, want, h):
    """The library reports the limits tests/test_torch_build_solve.py
    assumes, and its launch accepts them: k at the largest it takes, with
    the stream split, and a hot head one column wider than a slice."""
    limits = kernels.build_solve_limits(dtype)
    assert tuple(limits) == want
    x, b = build_solve.build_solve(
        *_bs_args(2, 4096, limits.max_k, h, dtype, cuda))
    wide = limits.hot_max_slice + 1
    x_hot, _ = build_solve.build_solve(*_bs_args(3, 40, 16, wide, dtype, cuda))
    torch.cuda.synchronize()
    assert build_solve.hot_split_count(3, wide, 16, kernels.sm_count(cuda),
                                       limits) >= 2
    for t in (x, b, x_hot):
        assert torch.isfinite(t).all()


def _gather_inputs(rows, k, n, dtype, idx_dtype, device, fill=False, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    table = torch.randn(rows, k, generator=g, dtype=torch.float64).to(dtype)
    lo, hi = (-rows - 3, rows + 3) if fill else (0, rows)
    idx = torch.randint(lo, hi, (n,), generator=g).to(idx_dtype)
    return table.to(device), idx.to(device)


_GATHER_KERNELS = ["vec", "warp", "tile", "fill"]


def _check_gather(table, idx, kernel, **kw):
    """Bit for bit against the plain version, one launch counted."""
    before = dict(gather.launches)
    got = gather.gather_rows(table, idx, **kw)
    torch.cuda.synchronize()
    want = gather.gather_rows_plain(table, idx, kw.get("fill", False))
    assert got.shape == want.shape and torch.equal(got, want)
    before[kernel] += 1
    assert gather.launches == before


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [1, 255, 513, 1 << 20])
@pytest.mark.parametrize("k", [1, 3, 30, 64, 65, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("kernel", _GATHER_KERNELS)
def test_gather_matches_plain(cuda, kernel, dtype, k, n, idx_dtype):
    fill = kernel == "fill"
    table, idx = _gather_inputs(997, k, n, dtype, idx_dtype, cuda, fill,
                                seed=k + n)
    _check_gather(table, idx, kernel, fill=fill,
                  variant="vec" if fill else kernel)


@pytest.mark.parametrize("dtype,width", [(torch.bfloat16, 2),
                                         (torch.float32, 4),
                                         (torch.float64, 8)])
@pytest.mark.parametrize("kernel", _GATHER_KERNELS)
def test_gather_from_a_misaligned_view(cuda, kernel, dtype, width):
    """A table that starts one element into its storage: 128-, 256- or
    512-byte rows that no 16-byte vector can copy."""
    fill = kernel == "fill"
    g = torch.Generator(device="cpu").manual_seed(5)
    flat = torch.randn(1 + 997 * 64, generator=g, dtype=torch.float64)
    table = flat.to(dtype).to(cuda)[1:].view(997, 64)
    lo, hi = (-1000, 1000) if fill else (0, 997)
    idx = torch.randint(lo, hi, (40, 50), generator=g).to(cuda)
    assert table.data_ptr() % 16 and gather.vector_bytes(
        64 * table.element_size(), table.data_ptr(), 0) == width
    _check_gather(table, idx, kernel, fill=fill,
                  variant="vec" if fill else kernel)


@pytest.mark.parametrize("n", [31, 32, 33, 3 * 32 * 8 * 132 * 3 + 5])
def test_gather_tile_tails_and_stage_reuse(cuda, n):
    """Index counts around one tile of 32 rows, and three tiles for every
    warp of a full grid (132 SMs x 3 blocks x 8 warps), so that each reuses
    a stage, with a short last tile;
    int64 indices; a row longer than a tile."""
    table, idx = _gather_inputs(997, 64, n, torch.bfloat16, torch.int64, cuda,
                                seed=n)
    assert gather.tile_plan(128, table.data_ptr(), 0).rows == 32
    _check_gather(table, idx, "tile", variant="tile")
    wide, idx = _gather_inputs(50, 1280, min(n, 4099), torch.float64,
                               torch.int32, cuda, seed=n)
    assert gather.tile_plan(10240, wide.data_ptr(), 0).rows == 1
    _check_gather(wide, idx, "tile", variant="tile")


@pytest.mark.parametrize("k,offset,want", [
    (14528, 0, (1, 2, 16)),  # two tiles of one 116224-byte row
    (29055, 1, (1, 1, 8)),  # one tile of 232440 bytes, copied by lanes
])
def test_gather_tile_fills_a_blocks_shared_memory(cuda, k, offset, want):
    """The longest rows the plan accepts launch: the tiles of one warp are
    all of a block's shared memory, to the byte."""
    g = torch.Generator(device="cpu").manual_seed(k)
    flat = torch.randn(offset + 3 * k, generator=g, dtype=torch.float64)
    table = flat.to(cuda)[offset:].view(3, k)
    idx = torch.tensor([2, 0, 1, 1, 2], device=cuda)
    assert gather.tile_plan(8 * k, table.data_ptr(), 8 * offset) == want
    got = gather.gather_rows(table, idx, "tile")
    torch.cuda.synchronize()
    assert torch.equal(got, gather.gather_rows_plain(table, idx))
    with pytest.raises(ValueError, match="shared memory"):
        gather.tile_plan(8 * (k + 2), table.data_ptr(), 0)


def test_gather_l2_window_sets_and_resets(cuda):
    """With the window the result is the same, and the persisting carve-out
    is back to 0 after the reset."""
    table, idx = _gather_inputs(65536, 64, 1 << 18, torch.bfloat16,
                                torch.int32, cuda)
    try:
        _check_gather(table, idx, "vec", l2_window=True)
        _check_gather(table, idx, "fill", fill=True, l2_window=True)
    finally:
        assert kernels.reset_l2_persistence(cuda) == 0
    _check_gather(table, idx, "vec")


def test_gather_rejects_a_strided_table(cuda):
    table, idx = _gather_inputs(100, 64, 10, torch.float32, torch.int64, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_rows(table[:, ::2], idx)
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_rows(table.t(), idx)


def test_launches_on_their_tensors_device_and_leave_the_current_one(cuda):
    """With cuda:1 current, the kernels launch on cuda:0 tensors, agree with
    their plain versions, and cuda:1 is current after each launch (the
    library sets the CUDA runtime's device; the wrappers' guard gives the
    caller's back). Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (one current, one launched on)")
    dev0 = torch.device("cuda", 0)
    a, b = _spd(37, 30, torch.float32, dev0)
    with torch.cuda.device(1):
        got = spd_solve.solve_spd(a, b)
        assert torch.cuda.current_device() == 1
        args = _bs_args(13, 64, 30, 0, torch.float32, dev0, seed=1)
        x, _ = build_solve.build_solve(*args)
        assert torch.cuda.current_device() == 1
        table, idx = _gather_inputs(100, 64, 10, torch.float32, torch.int64,
                                    dev0)
        rows = gather.gather_rows(table, idx, "vec")
        assert torch.cuda.current_device() == 1
    torch.cuda.synchronize(dev0)
    torch.testing.assert_close(got, spd_solve.solve_spd_reference(a, b),
                               rtol=2e-4, atol=2e-4)
    _assert_rowwise_close(x, build_solve.build_solve_reference(*args)[0], 2e-4)
    assert torch.equal(rows, gather.gather_rows_plain(table, idx))


@pytest.mark.parametrize("solver,hot_width", [("kernel", 0), ("fused", 8)])
def test_replayed_wals_epoch_equals_eager(cuda, solver, hot_width):
    """fuse_epoch's CUDA graph (ops/graphs.py): three epochs as a whole run,
    the first the warm-up and two replays, equal three eager epochs bit for
    bit (the kernels and the library calls on the path are
    deterministic), and the launch counters after the replays count what
    the eager epochs count. Factors replaced through load_factors feed the
    captured epoch: a second run from the first one's start, all replays,
    ends where the first did."""
    import numpy as np

    from qmf_tpu_torch.config import WALSConfig
    from qmf_tpu_torch.data import Dataset
    from qmf_tpu_torch.models import WALSEngine
    from qmf_tpu_torch.ops import graphs

    rng = np.random.default_rng(0)
    key = np.unique(rng.integers(0, 200 * 120, 3000))
    ds = Dataset(key // 120 + 1, key % 120 + 1,
                 rng.integers(1, 11, len(key)) * 0.5)

    def run(fuse_epoch):
        eng = WALSEngine(WALSConfig(
            nepochs=3, nfactors=32, batch_rows=64, solver=solver,
            hot_width=hot_width, matmul_precision="default",
            fuse_epoch=fuse_epoch), device=cuda)
        eng.init(ds)
        start[fuse_epoch] = (eng.user_factors.clone(),
                             eng.item_factors.clone())
        spd_solve.launches = build_solve.launches = 0
        build_solve.launches_hot = 0
        eng.optimize()
        torch.cuda.synchronize()
        return eng, (spd_solve.launches, build_solve.launches,
                     build_solve.launches_hot)

    start = {}
    graph, graph_counts = run(True)
    eager, eager_counts = run(False)
    assert isinstance(graph._program, graphs.EpochGraph)
    assert graph._program.replays == 2
    assert torch.equal(graph.user_factors, eager.user_factors)
    assert torch.equal(graph.item_factors, eager.item_factors)
    assert graph_counts == eager_counts and sum(eager_counts) > 0
    graph.load_factors(*start[True])
    graph.optimize()
    assert graph._program.replays == 5
    assert torch.equal(graph.item_factors, eager.item_factors)
    # every launch the counters add at a replay is a node of the graph: the
    # profiler sees each kernel the counters count in one replay (CUPTI may
    # drop one event, never add one)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = kernels.read_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph._program.replay(graph.item_factors)
        torch.cuda.synchronize()
    delta = dict(zip(kernels.counter_names(),
                     (a - b for a, b in zip(kernels.read_counters(), before))))
    seen = dict.fromkeys(("chol_solve_kernel", "build_solve_kernel",
                          "reduce_solve_kernel", "hot_gemm_kernel"), 0)
    for e in prof.key_averages():
        for name in seen:
            if e.device_type == DeviceType.CUDA and name in e.key:
                seen[name] += e.count
    for got, want in (
            (seen["chol_solve_kernel"], delta["spd_solve.launches"]),
            (seen["build_solve_kernel"] + seen["reduce_solve_kernel"],
             delta["build_solve.launches"]
             + delta["build_solve.launches_hot"]),
            (seen["hot_gemm_kernel"], delta["build_solve.launches_hot"])):
        assert want - 1 <= got <= want, (seen, delta)
    assert sum(delta.values()) > 0


_CAPTURE_ONE_SOLVE = """
import json, sys
import torch
from qmf_tpu_torch.ops import als_ops, graphs
from qmf_tpu_torch.ops.spd_solve import solve_spd_reference

solver, rows, k = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
g = torch.Generator().manual_seed(rows + k)
m = torch.randn(rows, k, k, generator=g, dtype=torch.float64)
a = (m @ m.transpose(1, 2) / k + torch.eye(k, dtype=torch.float64)).to(
    "cuda", torch.float32)
b = torch.randn(rows, k, generator=g, dtype=torch.float64).to(
    "cuda", torch.float32)
graph = graphs.EpochGraph(lambda a, b: als_ops._solve_dispatch(a, b, solver))
try:
    graph(a, b)  # the warm-up, then the capture
except RuntimeError as exc:
    print(json.dumps({"captured": False, "error": str(exc)[:400]}))
    sys.exit(0)
x = graph(a, b)
torch.cuda.synchronize()
err = float((x - solve_spd_reference(a, b)).abs().max())
print(json.dumps({"captured": True, "max_abs_err": err}))
"""


@pytest.mark.parametrize("solver", ["kernel", "cholesky", "lu"])
def test_uncaptured_solvers_table_holds(cuda, solver):
    """ops/graphs.py's UNCAPTURED_SOLVERS holds on this card and torch: one
    batched solve of 8,192 systems of k = 64 in float32 (a ml20m class's
    size) through an EpochGraph, in a process of its own (a refused capture
    can leave the CUDA context unusable). A solver the table lists must be
    refused; one it does not list must capture and replay to its plain
    version's result within 1e-3."""
    import json
    import os
    import subprocess
    import sys

    from qmf_tpu_torch.ops import graphs

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [root, os.environ.get("PYTHONPATH")]))}
    proc = subprocess.run(
        [sys.executable, "-c", _CAPTURE_ONE_SOLVE, solver, "8192", "64"],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    found = json.loads(proc.stdout.strip().splitlines()[-1])
    if solver in graphs.UNCAPTURED_SOLVERS:
        assert not found["captured"], (
            f"{solver!r} now captures: drop it from UNCAPTURED_SOLVERS")
        assert "captur" in found["error"].lower(), found["error"]
    else:
        assert found["captured"], found
        assert found["max_abs_err"] <= 1e-3, found


def _bpr_engines(cuda, **kw):
    """(graph engine, eager engine) of one BPR configuration on the card,
    each trained three epochs from the same seed, under
    torch.use_deterministic_algorithms: index_add_ then sums duplicate rows
    in a fixed order (a sort) rather than by atomics, whose order differs
    from run to run, so an epoch's result does not depend on the run that
    computed it and a replay can be held to an eager epoch bit for bit."""
    import numpy as np

    from qmf_tpu_torch.config import BPRConfig
    from qmf_tpu_torch.data import Dataset
    from qmf_tpu_torch.models import BPREngine

    rng = np.random.default_rng(0)
    ds = Dataset(rng.integers(1, 301, 6000), rng.integers(1, 401, 6000),
                 np.ones(6000))
    engines = []
    torch.use_deterministic_algorithms(True)
    try:
        for graphed in (True, False):
            eng = BPREngine(BPRConfig(nepochs=3, nfactors=16, init_seed=1,
                                      **kw), device=cuda)
            eng.init(ds)
            if not graphed:
                eng._program = eng._epoch_body()  # eager on the card
            eng.optimize()
            torch.cuda.synchronize()
            engines.append(eng)
    finally:
        torch.use_deterministic_algorithms(False)
    return engines


@pytest.mark.parametrize("kw,path", [
    (dict(neg_sampler="rounds", batch_size=1024), "grouped"),
    (dict(grouped_epoch=False, batch_size=1024), "packed"),
    (dict(grouped_epoch=False, batch_size=1000), "instep"),
], ids=["grouped-rounds", "legacy-packed", "legacy-instep"])
def test_replayed_bpr_epoch_equals_eager(cuda, kw, path):
    """BPR's epoch programs on the card (ops/graphs.py): the whole grouped
    epoch (pass 1 with its fixed collision buffer, then the SGD loop) with
    the ``rounds`` sampler, the packed legacy epoch, and the in-step legacy
    epoch as a one-step graph replayed once a step: three epochs, the first
    the warm-up and capture, equal three eager epochs bit for bit."""
    from qmf_tpu_torch.ops import graphs

    graph, eager = _bpr_engines(cuda, **kw)
    assert path == ("grouped" if graph._grouped else "packed"
                    if graph._legacy_packed() else "instep")
    program = graph._program
    assert isinstance(program, graphs.EpochGraph) and program.nodes > 0
    steps = graph._tri_users.shape[0] // 1000 if path == "instep" else 1
    assert program.replays == 3 * steps - 1
    for a, b in zip(graph.params, eager.params):
        assert torch.equal(a, b)
    assert graph.overflow_slots == eager.overflow_slots


@pytest.mark.parametrize("hot_width", [0, 8])
def test_class_solve_false_on_the_card_equals_true(cuda, hot_width):
    """WALS with class_solve=False on the card (chol_solve.cu once a chunk,
    inside the whole run's CUDA graph) gives class_solve=True's factors
    bit for bit: the kernel solves each system alone. It launches the
    kernel once a chunk, True once a class."""
    import numpy as np

    from qmf_tpu_torch.config import WALSConfig
    from qmf_tpu_torch.data import Dataset
    from qmf_tpu_torch.models import WALSEngine
    from qmf_tpu_torch.ops import graphs

    rng = np.random.default_rng(1)
    key = np.unique(rng.integers(0, 300 * 200, 9000))
    ds = Dataset(key // 200 + 1, key % 200 + 1,
                 rng.integers(1, 11, len(key)) * 0.5)
    runs = {}
    for class_solve in (False, True):
        eng = WALSEngine(WALSConfig(
            nepochs=3, nfactors=32, batch_rows=64, solver="kernel",
            hot_width=hot_width, class_solve=class_solve), device=cuda)
        eng.init(ds)
        spd_solve.launches = 0
        eng.optimize()
        torch.cuda.synchronize()
        assert isinstance(eng._program, graphs.EpochGraph)
        runs[class_solve] = (eng, spd_solve.launches)
    (split, n_split), (whole, n_whole) = runs[False], runs[True]
    assert torch.equal(split.user_factors, whole.user_factors)
    assert torch.equal(split.item_factors, whole.item_factors)
    n_chunks = sum(-(-arr[0].shape[0] // c) for side in ("user", "item")
                   for arr, c in zip(getattr(split, f"_{side}_classes"),
                                     getattr(split, f"_{side}_chunks")))
    n_classes = len(split._user_classes) + len(split._item_classes)
    assert (n_split, n_whole) == (3 * n_chunks, 3 * n_classes)
    assert n_chunks > n_classes


@pytest.mark.parametrize("solver", ["kernel", "fused"])
def test_auto_hot_widths_on_the_card(cuda, solver):
    """hot_width="auto" in float32 on a card: each side's resolved width is
    ops/hot.py's pick on the same degrees; and with the user side forced to H = 256 and the item
    side to 0, three epochs as a whole run (a warm-up and two replays)
    equal three eager epochs bit for bit."""
    import numpy as np

    from qmf_tpu_torch.config import WALSConfig
    from qmf_tpu_torch.data import Dataset
    from qmf_tpu_torch.models import WALSEngine
    from qmf_tpu_torch.ops import graphs, hot
    from qmf_tpu_torch.tools import hot_micro

    rng = np.random.default_rng(4)
    p = 1.0 / np.arange(1, 701)
    key = np.unique(rng.integers(0, 3000, 60_000) * 700
                    + rng.choice(700, size=60_000, p=p / p.sum()))
    ds = Dataset(key // 700 + 1, key % 700 + 1,
                 rng.integers(1, 11, len(key)) * 0.5)
    eng = WALSEngine(WALSConfig(nfactors=32, solver=solver,
                                matmul_precision="default"), device=cuda)
    eng.init(ds)
    demand = hot_micro.side_demand(ds)
    assert eng.hot_widths == {side: hot.auto_hot_width(*demand[side], 32)
                              for side in ("user", "item")}
    widths = {"user": 256, "item": 0}
    runs = {}
    for fuse_epoch in (True, False):
        eng = hot_micro.forced_engine(ds, WALSConfig(
            nepochs=3, nfactors=32, batch_rows=256, solver=solver,
            matmul_precision="default", fuse_epoch=fuse_epoch), widths, cuda)
        assert eng.hot_widths == widths and eng._item_hot is None
        eng.optimize()
        torch.cuda.synchronize()
        runs[fuse_epoch] = eng
    assert isinstance(runs[True]._program, graphs.EpochGraph)
    assert runs[True]._program.replays == 2
    assert torch.equal(runs[True].user_factors, runs[False].user_factors)
    assert torch.equal(runs[True].item_factors, runs[False].item_factors)
