"""Serving's seen-item exclusion (``ops/exclude_seen.py``) against the grid search it replaced.

The scatter of ``-inf`` at each user's CSR entries must give the scores that
``scores.masked_fill(_is_member(...))`` over the batch's (users, items) grid
gives, bit for bit: on the CPU through the plain version, on a card through
``csrc/exclude_seen.cu`` (tests marked ``gpu``, which skip unless a CUDA
device and nvcc are present). ``bpr_ops._is_member`` itself is held to
qmf_tpu's in tests/test_torch_recommend.py. This file imports no jax, so on
a card run it without the repo's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_exclude_seen.py
"""

import numpy as np
import pytest
import torch

from qmf_tpu_torch import kernels
from qmf_tpu_torch.models.recommend import _top_n, recommend_top_n
from qmf_tpu_torch.ops import als_ops, exclude_seen
from qmf_tpu_torch.ops.bpr_ops import PosSet, _is_member, make_pos_set

_DTYPES = [torch.float32, torch.float64, torch.bfloat16]


def _device(name: str) -> torch.device:
    if name == "cuda" and not kernels.available():
        pytest.skip("needs a CUDA device and nvcc (kernels.available() is "
                    "False)")
    return torch.device(name)


def _grid_search(scores: torch.Tensor, pos_set: PosSet,
                 users: torch.Tensor) -> torch.Tensor:
    """The exclusion as serving did it before the scatter: the binary
    search at every (user, item) of the batch's grid."""
    grid = scores.shape
    items = torch.arange(grid[1], dtype=torch.int32, device=scores.device)
    seen = _is_member(pos_set, users.unsqueeze(1).expand(grid),
                      items.unsqueeze(0).expand(grid))
    return scores.masked_fill(seen, -torch.inf)


def _case(name: str):
    """(scores width, pos set, batch users) of one case, seeded."""
    rng = np.random.default_rng(11)
    n_users, n_items = 40, 97
    u = rng.integers(0, n_users, 700)
    i = rng.integers(0, n_items, 700)
    users = rng.permutation(n_users)[:24]
    if name == "empty_set":
        u, i = u[:0], i[:0]
    elif name == "empty_segments":  # users 0-9 have no items
        keep = u >= 10
        u, i = u[keep], i[keep]
        users = np.arange(4, 20)
    elif name == "ids_outside_the_width":
        i = np.where(rng.random(700) < 0.2, i + n_items, i)
        i[:5] = -1 - np.arange(5)
    elif name == "repeated_user":
        users = np.array([3, 3, 7, 3, 7, 0, 3])
    return n_items, make_pos_set(u, i, n_users, device="cpu"), \
        torch.from_numpy(users.astype(np.int32))


_CASES = ["general", "empty_set", "empty_segments", "ids_outside_the_width",
          "repeated_user"]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("case", _CASES)
def test_plain_scatter_equals_the_grid_search(case, dtype):
    width, pos_set, users = _case(case)
    g = torch.Generator().manual_seed(5)
    scores = torch.randn(users.shape[0], width, generator=g).to(dtype)
    want = _grid_search(scores, pos_set, users)
    before = exclude_seen.launches
    for got in (exclude_seen.exclude_seen_plain(scores.clone(), pos_set,
                                                users),
                exclude_seen.exclude_seen_(scores.clone(), pos_set, users)):
        assert got.dtype == dtype
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert exclude_seen.launches == before  # a CPU call launches nothing
    if case == "ids_outside_the_width":
        assert (pos_set.items >= width).any() and (pos_set.items < 0).any()
    if case not in ("empty_set", "empty_segments"):
        assert torch.isinf(want).any()


@pytest.mark.parametrize("what,match", [
    ("float16", "float32, float64 or bfloat16"),
    ("users_shape", "users for"),
    ("users_dtype", "int32 users"),
    ("indptr_dtype", "int32 positive set"),
    ("scores_1d", r"\(B, I\)"),
])
def test_exclude_seen_refuses(what, match):
    width, pos_set, users = _case("general")
    scores = torch.zeros(users.shape[0], width)
    if what == "float16":
        scores = scores.half()
    elif what == "users_shape":
        users = users[:-1]
    elif what == "users_dtype":
        users = users.long()
    elif what == "indptr_dtype":
        pos_set = PosSet(pos_set.indptr.long(), pos_set.items,
                         pos_set.max_degree)
    else:
        scores = scores[0]
    with pytest.raises(ValueError, match=match):
        exclude_seen.exclude_seen_(scores, pos_set, users)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", _DTYPES)
def test_kernel_equals_plain_on_the_card(dtype):
    """1,024 rows over 3,000 items: segments of every length up to all the
    items (above one block's 256 threads and above 1,024), users repeated
    and with empty segments, ids at and above the width and negative."""
    dev = _device("cuda")
    rng = np.random.default_rng(3)
    n_users, n_items = 3000, 3000
    degree = np.minimum(rng.lognormal(4.0, 1.3, n_users).astype(int), n_items)
    degree[:3] = (n_items, 2500, 1025)
    degree[3:40] = 0
    u = np.repeat(np.arange(n_users), degree)
    i = np.concatenate([rng.choice(n_items + 60, d, replace=False) - 10
                        for d in degree])
    pos_set = make_pos_set(u, i, n_users, device=dev)
    users = np.concatenate([np.arange(64), rng.integers(0, n_users, 960)])
    users = torch.from_numpy(users).to(dev, torch.int32)
    g = torch.Generator(device=dev).manual_seed(7)
    scores = torch.randn(1024, n_items, generator=g, device=dev).to(dtype)
    want = exclude_seen.exclude_seen_plain(scores.clone(), pos_set, users)
    before = exclude_seen.launches
    got = exclude_seen.exclude_seen_(scores.clone(), pos_set, users)
    torch.cuda.synchronize()
    assert exclude_seen.launches == before + 1
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(want, _grid_search(scores, pos_set, users))
    assert int(torch.isinf(want[0]).sum()) > 2500


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda", marks=pytest.mark.gpu)])
def test_recommend_top_n_equals_the_grid_search(device):
    """``recommend_top_n`` serves the same idx and scores, bit for bit, as
    the grid search followed by the same head, computed here."""
    dev = _device(device)
    rng = np.random.default_rng(8)
    n_users, n_items, k = 5000, 3000, 32
    u = np.repeat(np.arange(n_users), rng.integers(0, 400, n_users))
    i = rng.integers(0, n_items, u.shape[0])
    seen = make_pos_set(u, i, n_users, device=dev)
    g = torch.Generator(device=dev).manual_seed(8)
    uf = torch.randn(n_users, k, generator=g, device=dev)
    itf = torch.randn(n_items, k, generator=g, device=dev)
    itf[1::7] = itf[::7][:itf[1::7].shape[0]]  # ties to order
    users = rng.permutation(n_users)[:1024].astype(np.int32)
    idx, top = recommend_top_n(uf, itf, users, n=10, seen=seen, device=dev)
    t = torch.from_numpy(users).to(dev)
    scores = _grid_search(als_ops.compute_scores(uf[t], itf), seen, t)
    want_idx, want_top = _top_n(scores, 10)
    np.testing.assert_array_equal(idx, want_idx.to(torch.int32).cpu().numpy())
    np.testing.assert_array_equal(top.view(np.uint32),
                                  want_top.cpu().numpy().view(np.uint32))


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda", marks=pytest.mark.gpu)])
def test_launches_once_a_request_with_a_seen_set(device):
    dev = _device(device)
    width, pos_set, users = _case("general")
    pos_set = PosSet(pos_set.indptr.to(dev), pos_set.items.to(dev),
                     pos_set.max_degree)
    uf = torch.randn(40, 8, device=dev)
    itf = torch.randn(width, 8, device=dev)
    per_call = 1 if dev.type == "cuda" else 0  # a CPU call launches nothing
    before = exclude_seen.launches
    for _ in range(3):
        recommend_top_n(uf, itf, users.numpy(), n=5, seen=pos_set,
                        device=dev)
    assert exclude_seen.launches == before + 3 * per_call
    recommend_top_n(uf, itf, users.numpy(), n=5, device=dev)
    empty = PosSet(torch.zeros(41, dtype=torch.int32, device=dev),
                   torch.zeros(0, dtype=torch.int32, device=dev), 0)
    exclude_seen.exclude_seen_(torch.zeros(0, width, device=dev), pos_set,
                               torch.zeros(0, dtype=torch.int32, device=dev))
    exclude_seen.exclude_seen_(torch.zeros(len(users), width, device=dev),
                               empty, users.to(dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    assert exclude_seen.launches == before + 3 * per_call
