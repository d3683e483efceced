"""Top-N serving of the port against qmf_tpu's, on the CPU.

Seeded numpy inputs go through both packages: the positive-set, bitmap and
Bloom structures must come out as equal arrays; the membership tests give
equal answers (bit 31 of a word and an empty set included);
``recommend_top_n`` gives equal lists and scores within 1e-12 in f64 and
1e-5 in f32 (lists compared where the score gap to the next item exceeds
1e-4); ties come out lower index
first; and on integer-valued factors both CLIs write the same bytes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qmf_tpu.cli import recommend as jax_cli
from qmf_tpu.models.recommend import recommend_top_n as jax_top_n
from qmf_tpu.ops import bpr_ops as jax_bpr
from qmf_tpu_torch.cli import recommend as port_cli
from qmf_tpu_torch.data import FactorData, IdIndex, save_factors
from qmf_tpu_torch.models import recommend as port_rec
from qmf_tpu_torch.ops import bpr_ops as port_bpr

N_USERS, N_ITEMS = 37, 101


def _pairs(seed, n=600, n_users=N_USERS, n_items=N_ITEMS):
    """Seeded (user, item) pairs with duplicates; user 3 has none."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, n)
    i = rng.integers(0, n_items, n)
    keep = u != 3
    u, i = u[keep], i[keep]
    return np.concatenate([u, u[:50]]), np.concatenate([i, i[:50]])


def _eq(tensor, jax_array):
    got = tensor.numpy()
    want = np.asarray(jax_array)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("return_sorted", [False, True])
def test_make_pos_set_equal(seed, return_sorted):
    u, i = _pairs(seed)
    got = port_bpr.make_pos_set(u, i, N_USERS, return_sorted, device="cpu")
    want = jax_bpr.make_pos_set(u, i, N_USERS, return_sorted)
    if return_sorted:
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
        got, want = got[0], want[0]
    _eq(got.indptr, want.indptr)
    _eq(got.items, want.items)
    assert got.max_degree == want.max_degree


def test_make_pos_set_empty():
    e = np.zeros(0, dtype=np.int64)
    got = port_bpr.make_pos_set(e, e, 4, device="cpu")
    want = jax_bpr.make_pos_set(e, e, 4)
    _eq(got.indptr, want.indptr)
    _eq(got.items, want.items)
    assert got.max_degree == want.max_degree == 0


# (pairs, users, items): dense branch (many words touched), sparse branch
# (distinct words * 8 < words * 4), and bit 31 of a word set (sparse too)
_BITMAP_CASES = {
    "dense": (600, N_USERS, N_ITEMS),
    "sparse": (40, 300, 2000),
    "bit31": (None, 5, 64),
}


def _bitmap_pairs(case):
    n, n_users, n_items = _BITMAP_CASES[case]
    if case == "bit31":
        return (np.array([0, 0, 2, 4, 4]), np.array([31, 63, 31, 0, 31]),
                n_users, n_items)
    u, i = _pairs(5, n, n_users, n_items)
    return u, i, n_users, n_items


@pytest.mark.parametrize("lex_sorted", [False, True])
@pytest.mark.parametrize("case", list(_BITMAP_CASES))
def test_make_pos_bitmap_equal(case, lex_sorted):
    u, i, n_users, n_items = _bitmap_pairs(case)
    if lex_sorted:
        _, u, i = jax_bpr.make_pos_set(u, i, n_users, return_sorted=True)
    got = port_bpr.make_pos_bitmap(u, i, n_users, n_items, lex_sorted,
                                   device="cpu")
    want = jax_bpr.make_pos_bitmap(u, i, n_users, n_items, lex_sorted)
    _eq(got.words, want.words)
    assert got.words_per_user == want.words_per_user
    starts = len(np.unique(u * got.words_per_user + (i >> 5)))
    assert (starts * 8 < n_users * got.words_per_user * 4) == (case != "dense")
    if case == "bit31":
        assert int(got.words[0]) < 0  # bit 31 set: a negative int32 word


def test_make_pos_bitmap_rejects_int32_overflow():
    with pytest.raises(ValueError, match="overflows int32"):
        port_bpr.make_pos_bitmap(np.array([0]), np.array([0]), 2**20, 2**17,
                                 device="cpu")


@pytest.mark.parametrize("bits", [32, 256])
def test_bloom_positions_bit_for_bit(bits):
    """The torch form against the numpy uint32 form, on items that include
    0, 2^31 - 1 and, as negative int32, values at and above 2^31."""
    rng = np.random.default_rng(2)
    items = np.concatenate([
        rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint32)])
    want = jax_bpr._bloom_positions(items, bits)
    own = port_bpr._bloom_positions(items, bits)
    for dtype in (np.int32, np.int64):
        got = port_bpr._bloom_positions(
            torch.from_numpy(items.astype(np.int64).astype(dtype)), bits)
        for g, o, w in zip(got, own, want):
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
            np.testing.assert_array_equal(o, w)


@pytest.mark.parametrize("bits", [32, 128])
def test_make_pos_bloom_equal(bits):
    u, i = _pairs(7)
    got = port_bpr.make_pos_bloom(u, i, N_USERS, bits, device="cpu")
    want = jax_bpr.make_pos_bloom(u, i, N_USERS, bits)
    _eq(got.words, want.words)
    assert got.words_per_user == want.words_per_user
    with pytest.raises(ValueError, match="power of two"):
        port_bpr.make_pos_bloom(u, i, N_USERS, 48, device="cpu")


def _grid(n_users, n_items):
    users = np.repeat(np.arange(n_users, dtype=np.int32), n_items)
    cand = np.tile(np.arange(n_items, dtype=np.int32), n_users)
    return users, cand


@pytest.mark.parametrize("structure", ["set", "bitmap", "bloom"])
@pytest.mark.parametrize("case", ["dense", "bit31"])
def test_membership_equal_on_the_grid(structure, case):
    u, i, n_users, n_items = _bitmap_pairs(case)
    users, cand = _grid(n_users, n_items)
    tu, tc = torch.from_numpy(users), torch.from_numpy(cand)
    ju, jc = jnp.asarray(users), jnp.asarray(cand)
    truth = np.zeros((n_users, n_items), dtype=bool)
    truth[u, i] = True
    if structure == "set":
        got = port_bpr._is_member(
            port_bpr.make_pos_set(u, i, n_users, device="cpu"), tu, tc)
        want = jax_bpr._is_member(jax_bpr.make_pos_set(u, i, n_users), ju, jc)
    elif structure == "bitmap":
        got = port_bpr._is_member_bitmap(
            port_bpr.make_pos_bitmap(u, i, n_users, n_items, device="cpu"),
            tu, tc)
        want = jax_bpr._is_member_bitmap(
            jax_bpr.make_pos_bitmap(u, i, n_users, n_items), ju, jc)
    else:
        got = port_bpr._is_member_bloom(
            port_bpr.make_pos_bloom(u, i, n_users, 64, device="cpu"), tu, tc)
        want = jax_bpr._is_member_bloom(
            jax_bpr.make_pos_bloom(u, i, n_users, 64), ju, jc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if structure == "bloom":  # no false negatives
        assert got.numpy()[truth.ravel()].all()
    else:
        np.testing.assert_array_equal(got.numpy(), truth.ravel())


def test_is_member_empty_set():
    e = np.zeros(0, dtype=np.int64)
    users, cand = _grid(3, 5)
    got = port_bpr._is_member(port_bpr.make_pos_set(e, e, 3, device="cpu"),
                              torch.from_numpy(users), torch.from_numpy(cand))
    want = jax_bpr._is_member(jax_bpr.make_pos_set(e, e, 3),
                              jnp.asarray(users), jnp.asarray(cand))
    assert got.dtype == torch.bool and not got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _factors(dtype, seed=3, k=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_USERS, k)).astype(dtype),
            rng.normal(size=(N_ITEMS, k)).astype(dtype),
            rng.normal(size=N_ITEMS).astype(dtype))


@pytest.mark.parametrize("with_seen", [False, True])
@pytest.mark.parametrize("with_biases", [False, True])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_recommend_top_n_matches(dtype, tol, with_biases, with_seen):
    uf, itf, bias = _factors(dtype)
    biases = bias if with_biases else None
    u, i = _pairs(9)
    users = np.array([5, 0, 3, 36, 5, 17])
    n = 7
    got_idx, got_sc = port_rec.recommend_top_n(
        uf, itf, users, n=n, item_biases=biases, device="cpu",
        seen=port_bpr.make_pos_set(u, i, N_USERS, device="cpu")
        if with_seen else None)
    want_idx, want_sc = jax_top_n(
        uf, itf, users, n=n, item_biases=biases,
        seen=jax_bpr.make_pos_set(u, i, N_USERS) if with_seen else None)
    assert got_idx.shape == (len(users), n) and got_idx.dtype == np.int32
    assert got_sc.dtype == dtype == want_sc.dtype
    np.testing.assert_allclose(got_sc, want_sc, rtol=0, atol=tol)
    if dtype == np.float64:
        np.testing.assert_array_equal(got_idx, want_idx)
    else:
        # f32 sums in another order: positions may swap inside a near-tie
        scores = uf[users].astype(np.float64) @ itf.T.astype(np.float64)
        if with_biases:
            scores += bias
        if with_seen:
            scores[np.isin(users[:, None] * N_ITEMS + np.arange(N_ITEMS),
                           u * N_ITEMS + i)] = -np.inf
        ranked = -np.sort(-scores, axis=1)
        clear = np.all(ranked[:, :n] - ranked[:, 1:n + 1] > 1e-4, axis=1)
        assert clear.sum() >= 3
        np.testing.assert_array_equal(got_idx[clear], want_idx[clear])
    if with_seen:
        seen_pairs = set(zip(u.tolist(), i.tolist()))
        assert not any((int(us), int(it)) in seen_pairs
                       for us, row in zip(users, got_idx) for it in row)


def _tied_factors():
    """Integer-valued factors with many equal scores; user 1 has seen all
    but 3 items, user 2 everything."""
    rng = np.random.default_rng(4)
    uf = rng.integers(-2, 3, (6, 4)).astype(np.float64)
    itf = rng.integers(-1, 2, (12, 4)).astype(np.float64)
    itf[7] = itf[2]
    itf[9] = itf[2]
    su = np.concatenate([np.full(9, 1), np.full(12, 2), [0, 4]])
    si = np.concatenate([np.arange(9), np.arange(12), [3, 3]])
    return uf, itf, su, si


@pytest.mark.parametrize("with_seen", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_recommend_ties_lower_index_first(dtype, with_seen):
    uf, itf, su, si = _tied_factors()
    uf, itf = uf.astype(dtype), itf.astype(dtype)
    users = np.arange(6)
    got_idx, got_sc = port_rec.recommend_top_n(
        uf, itf, users, n=5, device="cpu",
        seen=port_bpr.make_pos_set(su, si, 6, device="cpu")
        if with_seen else None)
    want_idx, want_sc = jax_top_n(
        uf, itf, users, n=5,
        seen=jax_bpr.make_pos_set(su, si, 6) if with_seen else None)
    np.testing.assert_array_equal(got_sc, want_sc)
    np.testing.assert_array_equal(got_idx, want_idx)
    # scores descend, and equal scores come in index order
    assert (got_sc[:, :-1] >= got_sc[:, 1:]).all()
    tie = got_sc[:, :-1] == got_sc[:, 1:]
    assert tie.any() and (np.diff(got_idx, axis=1)[tie] > 0).all()
    if with_seen:
        assert np.isinf(got_sc[1, 3:]).all() and np.isfinite(got_sc[1, :3]).all()
        assert np.isinf(got_sc[2]).all()
        np.testing.assert_array_equal(got_idx[2], np.arange(5))


def test_top_n_repairs_any_topk_order(monkeypatch):
    """Whatever members of a tie torch.topk returns, the head is the lowest
    indices: here topk is replaced by one that prefers the highest."""
    scores = torch.tensor([[1.0, 3.0, 3.0, 3.0, 0.0, 3.0],
                           [2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                           [-torch.inf, 5.0, -torch.inf, -torch.inf, 5.0, 1.0]])
    real_topk = torch.topk

    def highest_first(t, n, dim=1):
        flipped = real_topk(t.flip(dim), n, dim=dim)
        return torch.return_types.topk(
            (flipped.values, t.shape[dim] - 1 - flipped.indices))

    monkeypatch.setattr(torch, "topk", highest_first)
    idx, top = port_rec._top_n(scores, 3)
    assert idx.tolist() == [[1, 2, 3], [0, 1, 2], [1, 4, 5]]
    assert top.tolist() == [[3.0, 3.0, 3.0], [2.0, 2.0, 2.0], [5.0, 5.0, 1.0]]
    with pytest.raises(ValueError, match="NaN"):
        port_rec._top_n(torch.tensor([[1.0, float("nan"), 0.5]]), 2)


def _save(tmp_path, name, factors, ids, biases=None):
    fd = FactorData(*factors.shape, with_biases=biases is not None)
    fd.factors[:] = factors
    if biases is not None:
        fd.biases[:] = biases
    path = tmp_path / name
    save_factors(fd, IdIndex(np.asarray(ids)), str(path))
    return path


@pytest.mark.parametrize("mode", ["plain", "seen", "biases", "users"])
def test_cli_files_byte_identical(tmp_path, mode):
    """Integer-valued factors (exact scores in f32 and f64, many ties, users
    with fewer than topn unseen items): both CLIs write the same bytes."""
    uf, itf, su, si = _tied_factors()
    user_ids = np.array([11, 5, 8, 42, 7, 3])
    item_ids = np.arange(12)[::-1] * 3 + 1
    up = _save(tmp_path, "u.dat", uf, user_ids)
    biases = np.arange(12) % 3 - 1.0 if mode == "biases" else None
    ip = _save(tmp_path, "i.dat", itf, item_ids, biases)
    args = [f"--user_factors={up}", f"--item_factors={ip}", "--topn=5",
            "--batch_users=4"]
    if mode == "seen":
        seen = tmp_path / "seen.txt"
        lines = [f"{user_ids[u]} {item_ids[i]} 1" for u, i in zip(su, si)]
        lines.append("999 1 1")  # ids in neither factor file are dropped
        seen.write_text("\n".join(lines + [lines[0]]) + "\n")
        args.append(f"--exclude_seen={seen}")
    if mode == "biases":
        args.append("--item_biases")
    if mode == "users":
        args.append("--users=7,11,7")
    got, want = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert port_cli.main(args + [f"--output={got}", "--device=cpu"]) == 0
    assert jax_cli.main(args + [f"--output={want}"]) == 0
    assert got.read_bytes() == want.read_bytes()
    lines = got.read_text().splitlines()
    assert len(lines) == (3 if mode == "users" else 6)
    if mode == "seen":
        by_user = dict(line.split("\t") for line in lines)
        assert len(by_user["5"].split()) == 3  # 3 unseen items, -inf dropped
        assert by_user["8"] == ""  # everything seen


@pytest.mark.parametrize("args,rc", [
    ([], 1),
    (["--user_factors=U"], 1),
    (["--user_factors=U", "--item_factors=I", "--users=1,x"], 1),
    (["--user_factors=U", "--item_factors=I", "--users=99"], 1),
    (["--user_factors=U", "--item_factors=I", "--users=11", "--topn=99"], 0),
])
def test_cli_error_paths(tmp_path, capsys, args, rc):
    uf, itf, _, _ = _tied_factors()
    up = _save(tmp_path, "u.dat", uf, [11, 5, 8, 42, 7, 3])
    ip = _save(tmp_path, "i.dat", itf, np.arange(12))
    args = [a.replace("=U", f"={up}").replace("=I", f"={ip}") for a in args]
    assert port_cli.main(args + ["--device=cpu"]) == rc
    assert jax_cli.main(args) == rc
    if rc == 0:  # topn above the catalog: all 12 items, once each
        port_out, jax_out = capsys.readouterr().out.splitlines()
        assert port_out == jax_out
        assert len(port_out.split("\t")[1].split()) == 12
