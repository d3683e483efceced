"""The port's BPR ops against qmf_tpu's, on the CPU, draw for draw.

qmf_tpu's functions draw inside (``jax.random``); the port's inner functions
take the drawn integers. Each test replays the ``split`` / ``randint`` calls
of the JAX function, hands the port the same integers, and compares:

- hashes, presamplers and packed streams bit for bit (``torch.equal`` /
  ``assert_array_equal`` on int32);
- one SGD step in float64 within 1e-12 (both sum scatter duplicates in
  stream order on the CPU; what is left is the order of a few additions);
- three epochs in float64 within 1e-10, in float32 within 1e-5 (rounding of
  float32 sums of k <= 8 products of factors below 1, over ~20 steps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qmf_tpu.ops import bpr_ops as jax_bpr
from qmf_tpu_torch.ops import bpr_ops as port_bpr

I32 = torch.int32
KEY_MAX = (1 << 30) - 1


def _t(a, dtype=None):
    """A numpy or jax array as a CPU tensor (copied)."""
    return torch.tensor(np.asarray(a), dtype=dtype)


def _eq(tensor, jax_array):
    got, want = tensor.numpy(), np.asarray(jax_array)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _keys(key, shape):
    """qmf_tpu's key draw: int32 in [0, 2^30)."""
    return jax.random.randint(key, shape, 0, 1 << 30, dtype=jnp.int32)


# round keys: drawn, all zero, all 2^30 - 1
def _rks(n_rounds=4):
    return [np.asarray(_keys(jax.random.PRNGKey(5), (n_rounds, 3))),
            np.zeros((n_rounds, 3), np.int32),
            np.full((n_rounds, 3), KEY_MAX, np.int32)]


def _slots():
    rng = np.random.default_rng(0)
    return np.concatenate([
        np.array([0, 1, 2**31 - 1, 2**31 - 2, 2**30], np.int32),
        rng.integers(0, 2**31, 3000).astype(np.int32)])


# --- the hashes --------------------------------------------------------------

@pytest.mark.parametrize("which", [0, 1, 2])
def test_mix32_bit_for_bit(which):
    rk, f = _rks()[which], _slots()
    for r in range(4):
        got = port_bpr._mix32(_t(rk[r]), _t(f))
        _eq(got, jax_bpr._mix32(jnp.asarray(rk[r]), jnp.asarray(f)))
    # the last xor with an arithmetic x >> 9 clears bit 31
    assert int(got.min()) >= 0


def test_mix32_refuses_wider_integers():
    """An int64 slot index would promote the products and change the bits."""
    rk = _t(_rks()[0][0])
    with pytest.raises(TypeError, match="int32"):
        port_bpr._mix32(rk, torch.arange(4))
    with pytest.raises(TypeError, match="int32"):
        port_bpr._mix32(rk.to(torch.int64), torch.arange(4, dtype=I32))


@pytest.mark.parametrize("n_items", [1, 2, 26744, 2**31 - 1])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_cand_hash_bit_for_bit(n_items, which):
    rk, f = _rks()[which], _slots()
    got = port_bpr._cand_hash(_t(rk[1]), _t(f), n_items)
    _eq(got, jax_bpr._cand_hash(jnp.asarray(rk[1]), jnp.asarray(f), n_items))
    assert got.dtype == I32 and int(got.min()) >= 0 and int(got.max()) < n_items


@pytest.mark.parametrize("n", [1, 2, 26744, 2**31 - 1])
def test_uint32_modulo_and_logical_shift_on_negative_x(n):
    """_mix32 never returns a negative x, so the two helpers that stand in
    for uint32 arithmetic are held on negative int32 here, against numpy's
    uint32."""
    x = np.concatenate([_slots(), -_slots() - 1])
    got = port_bpr._umod(_t(x), n)
    want = (x.astype(np.uint32) % np.uint32(n)).astype(np.int32)
    assert got.dtype == I32
    np.testing.assert_array_equal(got.numpy(), want)
    for s in (1, 5, 9, 31):
        got = port_bpr._shift_right_logical(_t(x), s)
        want = (x.astype(np.uint32) >> np.uint32(s)).astype(np.int32)
        np.testing.assert_array_equal(got.numpy(), want)
        _eq(got, jax.lax.shift_right_logical(jnp.asarray(x), jnp.int32(s)))


@pytest.mark.parametrize("wpu", [1, 3, 836, 2**26 + 1])
def test_word_probe_bit_for_bit(wpu):
    f = _slots()
    for rk in _rks():
        w, b0 = port_bpr._word_probe(_t(rk[0]), _t(f), wpu)
        want_w, want_b0 = jax_bpr._word_probe(
            jnp.asarray(rk[0]), jnp.asarray(f), wpu)
        _eq(w, want_w)
        _eq(b0, want_b0)


@pytest.mark.parametrize("n_items", [1, 31, 32, 33, 75, 26744, 26752])
def test_word_tail_mask_equal(n_items):
    wpu = (n_items + 31) // 32
    assert port_bpr._word_tail_mask(n_items, wpu) == \
        jax_bpr._word_tail_mask(n_items, wpu)


def test_word_sampler_applies_equal():
    for num_neg in range(0, 18):
        for n_rounds in range(0, 6):
            assert port_bpr.word_sampler_applies(num_neg, n_rounds) == \
                jax_bpr.word_sampler_applies(num_neg, n_rounds)
    assert port_bpr._WORD_DELTA == jax_bpr._WORD_DELTA
    assert port_bpr._PACK_SHIFT == jax_bpr._PACK_SHIFT


def _fixed_randint(monkeypatch, ks):
    """Make qmf_tpu's next key draw return ``ks``."""
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(ks, jnp.int32))


@pytest.mark.parametrize("m,b", [(1, 0), (1, 4), (3, 5), (7, 8), (550, 6)])
def test_feistel_bijection_bit_for_bit(m, b):
    key = jax.random.PRNGKey(m + b)
    ks = _keys(key, (6,))
    got = port_bpr._feistel_bijection(_t(ks), m, b)
    _eq(got, jax_bpr._feistel_bijection(key, m, b))
    # a permutation of [0, m * 2^b), m not a power of two included
    assert np.array_equal(np.sort(got.numpy()), np.arange(m << b))


@pytest.mark.parametrize("ks", [[0] * 6, [KEY_MAX] * 6,
                                [0, KEY_MAX, 1, KEY_MAX - 1, 2**29, 12345]])
def test_feistel_bijection_extreme_keys(monkeypatch, ks):
    _fixed_randint(monkeypatch, ks)
    want = jax_bpr._feistel_bijection(jax.random.PRNGKey(0), 37, 5)
    got = port_bpr._feistel_bijection(torch.tensor(ks, dtype=I32), 37, 5)
    _eq(got, want)
    assert np.array_equal(np.sort(got.numpy()), np.arange(37 << 5))


@pytest.mark.parametrize("kbits", [0, 1, 5, 12])
def test_mix_bijection_bit_for_bit(kbits):
    key = jax.random.PRNGKey(kbits)
    ks = _keys(key, (3,))
    got = port_bpr._mix_bijection(_t(ks), 1 << kbits, kbits)
    _eq(got, jax_bpr._mix_bijection(key, 1 << kbits, kbits))
    assert np.array_equal(np.sort(got.numpy()), np.arange(1 << kbits))


@pytest.mark.parametrize("ks", [[0] * 3, [KEY_MAX] * 3])
def test_mix_bijection_extreme_keys(monkeypatch, ks):
    _fixed_randint(monkeypatch, ks)
    want = jax_bpr._mix_bijection(jax.random.PRNGKey(0), 1 << 9, 9)
    _eq(port_bpr._mix_bijection(torch.tensor(ks, dtype=I32), 1 << 9, 9), want)


def test_draws_come_from_the_generator():
    """Keys in [0, 2^30), candidates in [0, n_items), int32, and the same
    seed gives the same draws; the global RNG is not read."""
    state = torch.get_rng_state()
    g = torch.Generator().manual_seed(3)
    rk, ks = port_bpr.draw_grouped_keys(g, 4, True)
    cands = port_bpr._draw_candidates(g, (2, 500), 7)
    assert rk.shape == (4, 3) and ks.shape == (6,)
    assert rk.dtype == ks.dtype == cands.dtype == I32
    assert 0 <= int(rk.min()) and int(rk.max()) < 1 << 30
    assert 0 <= int(cands.min()) and int(cands.max()) == 6
    g2 = torch.Generator().manual_seed(3)
    rk2, ks2 = port_bpr.draw_grouped_keys(g2, 4, True)
    assert torch.equal(rk, rk2) and torch.equal(ks, ks2)
    assert port_bpr.draw_grouped_keys(g2, 4, False)[1] is None
    assert torch.equal(state, torch.get_rng_state())


# --- the presamplers ---------------------------------------------------------

N_USERS, N_ITEMS = 12, 75  # 75: the last bitmap word has an 11-bit tail


def _positives(seed=0, n=400, n_users=N_USERS, n_items=N_ITEMS):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, n).astype(np.int32),
            rng.integers(0, n_items, n).astype(np.int32))


def _structures(u, i, n_users=N_USERS, n_items=N_ITEMS, bloom_bits=64):
    """(jax, port) pairs of bitmap, bloom and CSR set."""
    return {
        "bitmap": (jax_bpr.make_pos_bitmap(u, i, n_users, n_items),
                   port_bpr.make_pos_bitmap(u, i, n_users, n_items,
                                            device="cpu")),
        "bloom": (jax_bpr.make_pos_bloom(u, i, n_users, bloom_bits),
                  port_bpr.make_pos_bloom(u, i, n_users, bloom_bits,
                                          device="cpu")),
        "set": (jax_bpr.make_pos_set(u, i, n_users),
                port_bpr.make_pos_set(u, i, n_users, device="cpu")),
    }


@pytest.mark.parametrize("num_neg", [1, 3])
@pytest.mark.parametrize("n_rounds", [1, 2, 4])
def test_sample_rounds_word_equal(n_rounds, num_neg):
    u, i = _positives()
    jb, pb = _structures(u, i)["bitmap"]
    users = np.random.default_rng(1).integers(0, N_USERS, 600).astype(np.int32)
    rk = _keys(jax.random.PRNGKey(7), (n_rounds, 3))
    want, want_over = jax_bpr._sample_rounds_word(
        rk, jnp.asarray(users), jb, N_ITEMS, n_rounds, num_neg)
    got, over = port_bpr._sample_rounds_word(
        _t(rk), _t(users), pb, N_ITEMS, n_rounds, num_neg)
    _eq(got, want)
    assert int(over) == int(want_over) == 0
    if n_rounds == 4:
        assert len(np.unique(got.numpy())) == 4  # every round index occurs


@pytest.mark.parametrize("cap", [600, 8])
@pytest.mark.parametrize("n_rounds", [1, 2, 4])
@pytest.mark.parametrize("membership", ["rounds", "bloom"])
def test_sample_rounds_equal(membership, n_rounds, cap):
    """The compacted presamplers; cap 8 is below the collider count, so
    the first 8 colliders in ascending order are re-sampled, the rest keep
    round 0, and the overflow counts equal qmf_tpu's."""
    u, i = _positives(n_items=16)
    st = _structures(u, i, n_items=16)
    users = np.random.default_rng(1).integers(0, N_USERS, 600).astype(np.int32)
    rk = _keys(jax.random.PRNGKey(7), (n_rounds, 3))
    if membership == "bloom":
        want, want_over = jax_bpr._sample_rounds_bloom(
            rk, jnp.asarray(users), st["bloom"][0], st["set"][0], 16,
            n_rounds, cap)
        got, over = port_bpr._sample_rounds_bloom(
            _t(rk), _t(users), st["bloom"][1], st["set"][1], 16, n_rounds,
            cap)
    else:
        want, want_over = jax_bpr._sample_rounds(
            rk, jnp.asarray(users), st["bitmap"][0], 16, n_rounds, cap)
        got, over = port_bpr._sample_rounds(
            _t(rk), _t(users), st["bitmap"][1], 16, n_rounds, cap)
    _eq(got, want)
    assert int(over) == int(want_over)
    assert over.dtype == I32 and over.shape == ()
    if n_rounds > 1 or membership == "bloom":
        assert (int(over) > 0) == (cap == 8)
    if cap == 8 and n_rounds == 4:
        assert int((got != 0).sum()) <= 8  # nothing beyond the cap was written


def _pack_args(num_neg, n_rounds, bs=128, n_pos=800, seed=5, n_users=50,
               n_items=N_ITEMS):
    u, i = _positives(seed, n_pos, n_users, n_items)
    pad = (-n_pos) % bs
    gu = np.concatenate([u, np.zeros(pad, np.int32)])
    gi = np.concatenate([i, np.zeros(pad, np.int32)])
    return u, i, np.stack([gu, gi], axis=1)


def _pack_both(key, pos_up, st, membership, shuffle, num_neg, n_rounds,
               n_real, n_items, feistel_b, collide_cap):
    """qmf_tpu's pack on ``key`` and the port's on the replayed draws:
    (jax enc, p, rk, overflow), (port enc, p, overflow), ks."""
    words = st["bloom" if membership == "bloom" else "bitmap"]
    kw = dict(n_items=n_items, n_real=n_real, num_neg=num_neg,
              n_rounds=n_rounds, wpu=words[0].words_per_user,
              u_shift=1 + 2 * num_neg, feistel_b=feistel_b,
              collide_cap=collide_cap, membership=membership,
              max_degree=st["set"][0].max_degree)
    csr = membership == "bloom"
    want = jax_bpr._sample_pack_grouped_impl(
        key, jnp.asarray(pos_up), words[0].words, shuffle=shuffle,
        indptr=st["set"][0].indptr if csr else None,
        csr_items=st["set"][0].items if csr else None, **kw)
    # the draws of _sample_pack_grouped_body, replayed
    key2, rkey = jax.random.split(key)
    rk = _keys(rkey, (n_rounds, 3))
    ks = None
    if shuffle:
        _, mkey = jax.random.split(key2)
        ks = _t(_keys(mkey, (6,)))
    got = port_bpr._sample_pack_grouped_body(
        _t(rk), ks, _t(pos_up), words[1].words,
        indptr=st["set"][1].indptr if csr else None,
        csr_items=st["set"][1].items if csr else None, **kw)
    return want, got, ks


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("membership", ["word", "bitmap", "bloom"])
def test_sample_pack_grouped_equal(membership, shuffle):
    num_neg, n_rounds, bs = 3, 4, 128
    u, i, pos_up = _pack_args(num_neg, n_rounds, bs)
    st = _structures(u, i, 50, N_ITEMS, bloom_bits=256)
    want, got, _ = _pack_both(
        jax.random.PRNGKey(3), pos_up, st, membership, shuffle, num_neg,
        n_rounds, len(u), N_ITEMS, 7, 4096)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert int(got[2]) == int(want[3]) == 0
    enc = got[0].numpy()
    assert (enc & 1).sum() == len(u)
    assert len(np.unique((enc >> 1) & 3)) > 1  # later rounds were chosen


# --- one step ------------------------------------------------------------------

U, I, K = 9, 32, 6  # 32 items: one full bitmap word, no tail


def _params(seed, dtype=np.float64, u=U, i=I, k=K):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(0, 0.3, (u, k)), rng.normal(0, 0.3, (i, k)),
            rng.normal(0, 0.3, i))
    return (jax_bpr.BPRParams(*(jnp.asarray(a, dtype) for a in arrs)),
            port_bpr.BPRParams(*(torch.tensor(a.astype(dtype))
                                 for a in arrs)))


def _max_err(port_params, jax_params):
    return max(float(np.abs(p.numpy() - np.asarray(j)).max())
               for p, j in zip(port_params, jax_params))


LR, LAM_U, LAM_I, LAM_B = 0.05, 0.025, 0.0025, 1.0


@pytest.mark.parametrize("sampler", ["word", "rounds"])
@pytest.mark.parametrize("use_biases", [False, True])
@pytest.mark.parametrize("item_scatter", ["seq", "merged", "dense"])
def test_grouped_step_equal(item_scatter, use_biases, sampler):
    """One step on a crafted batch: users repeat (9 users over 64 rows), an
    item is the positive of one row and the negative of another, and a
    quarter of the rows are zero-weight padding. Within 1e-12 in float64,
    and every gradient read the pre-batch parameters."""
    rng = np.random.default_rng(11)
    bs, num_neg, n_rounds = 64, 3, 4
    u_shift = 1 + 2 * num_neg
    users = rng.integers(0, U, bs).astype(np.int32)
    pos = rng.integers(0, I, bs).astype(np.int32)
    valid = (rng.random(bs) < 0.75).astype(np.int32)
    enc = (users << u_shift) | valid
    for j in range(num_neg):
        enc |= rng.integers(0, n_rounds, bs).astype(np.int32) << (1 + 2 * j)
    rk = _keys(jax.random.PRNGKey(2), (n_rounds, 3))
    jp, pp = _params(0)
    before = [t.clone() for t in pp]
    kw = dict(use_biases=use_biases, batch_size=bs, num_neg=num_neg,
              n_items=I, n_rounds=n_rounds, u_shift=u_shift,
              item_scatter=item_scatter, sampler=sampler, wpu=1)
    want = jax_bpr._sgd_epoch_scan_grouped_body(
        jp, jnp.asarray(enc), jnp.asarray(pos), rk, jnp.float64(LR),
        jnp.float64(LAM_U), jnp.float64(LAM_I), jnp.float64(LAM_B), **kw)
    got = port_bpr._sgd_epoch_scan_grouped_body(
        pp, _t(enc), _t(pos), _t(rk), LR, LAM_U, LAM_I, LAM_B, **kw)
    assert got is pp  # updated in place
    assert _max_err(got, want) <= 1e-12
    # the batch does what the test says it does
    if sampler == "rounds":
        f = np.arange(bs * num_neg, dtype=np.int32).reshape(bs, num_neg)
        r = np.stack([(enc >> (1 + 2 * j)) & 3 for j in range(num_neg)], 1)
        negs = np.zeros_like(f)
        for rr in range(n_rounds):
            c = np.asarray(jax_bpr._cand_hash(rk[rr], jnp.asarray(f), I))
            negs = np.where(r == rr, c, negs)
        live = valid.astype(bool)
        assert set(pos[live]) & set(negs[live].ravel())
    assert len(np.unique(users)) < bs and (valid == 0).any()
    assert float((got.user_factors - before[0]).abs().max()) > 1e-4
    if not use_biases:
        assert torch.equal(got.item_biases, before[2])


@pytest.mark.parametrize("use_biases", [False, True])
def test_sgd_update_body_equal(use_biases):
    """The triplet step: a user twice, item 3 positive of row 0 and negative
    of row 1, and a zero-weight row. Within 1e-12 in float64."""
    users = np.array([0, 0, 1, 2, 2, 5, 0, 7], np.int32)
    pos = np.array([3, 4, 3, 1, 1, 0, 2, 9], np.int32)
    neg = np.array([5, 3, 4, 3, 6, 1, 3, 2], np.int32)
    w = np.array([1, 1, 1, 1, 1, 1, 0, 1], np.float64)
    jp, pp = _params(1)
    want = jax_bpr._sgd_update_body(
        jp, jnp.asarray(users), jnp.asarray(pos), jnp.asarray(neg),
        jnp.asarray(w), jnp.float64(LR), jnp.float64(LAM_U),
        jnp.float64(LAM_I), jnp.float64(LAM_B), use_biases=use_biases)
    got = port_bpr._sgd_update_body(
        pp, _t(users), _t(pos), _t(neg), _t(w), LR, LAM_U, LAM_I, LAM_B,
        use_biases=use_biases)
    assert _max_err(got, want) <= 1e-12


# --- whole epochs ----------------------------------------------------------------

def _grouped_epoch_keys(key, n_rounds, shuffle):
    """The draws of qmf_tpu's sgd_epoch_grouped(key): (rk, ks)."""
    _, skey = jax.random.split(key)
    key2, rkey = jax.random.split(skey)
    rk = _t(_keys(rkey, (n_rounds, 3)))
    if not shuffle:
        return rk, None
    _, mkey = jax.random.split(key2)
    return rk, _t(_keys(mkey, (6,)))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-5)])
@pytest.mark.parametrize("item_scatter,use_biases,membership", [
    ("seq", False, "word"), ("seq", True, "word"),
    ("merged", True, "rounds"), ("merged", False, "bloom"),
    ("dense", True, "word"), ("dense", False, "rounds"),
])
def test_sgd_epoch_grouped_three_epochs(item_scatter, use_biases, membership,
                                        dtype, tol):
    num_neg, n_rounds, bs = 3, 4, 32
    n_users, n_items, n_pos = 20, 40, 300
    u, i, pos_up = _pack_args(num_neg, n_rounds, bs, n_pos, 9, n_users,
                              n_items)
    st = _structures(u, i, n_users, n_items, bloom_bits=64)
    jb, pb = st["bloom" if membership == "bloom" else "bitmap"]
    jp, pp = _params(2, dtype, n_users, n_items, 8)
    kw = dict(n_items=n_items, n_real=n_pos, use_biases=use_biases,
              num_neg=num_neg, neg_rounds=n_rounds, batch_size=bs,
              collide_cap=1024, item_scatter=item_scatter,
              sampler="word" if membership == "word" else "rounds")
    overflow = []
    for epoch in range(3):
        key = jax.random.PRNGKey(100 + epoch)
        jp, over_j = jax_bpr.sgd_epoch_grouped(
            jp, key, jnp.asarray(pos_up), jb, *(jnp.asarray(x, dtype) for x
                                                in (LR, LAM_U, LAM_I, LAM_B)),
            shuffle=True, pos_set=st["set"][0] if membership == "bloom"
            else None, **kw)
        rk, ks = _grouped_epoch_keys(key, n_rounds, True)
        pp, over_p = port_bpr.sgd_epoch_grouped_keyed(
            pp, rk, ks, _t(pos_up), pb, LR, LAM_U, LAM_I, LAM_B,
            pos_set=st["set"][1] if membership == "bloom" else None, **kw)
        overflow.append((int(over_j), int(over_p)))
    assert pp.user_factors.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    assert _max_err(pp, jp) <= tol
    assert all(a == b for a, b in overflow)


def test_sgd_epoch_grouped_draws_then_runs_keyed():
    """The outer function equals the keyed one on the same generator's
    draws, and bloom membership without its CSR set is refused."""
    num_neg, n_rounds, bs = 2, 3, 16
    u, i, pos_up = _pack_args(num_neg, n_rounds, bs, 100, 4, 10, 33)
    st = _structures(u, i, 10, 33)
    kw = dict(n_items=33, n_real=100, use_biases=True, num_neg=num_neg,
              neg_rounds=n_rounds, batch_size=bs, collide_cap=1024,
              sampler="word")
    a = port_bpr.sgd_epoch_grouped(
        _params(3, u=10, i=33)[1], torch.Generator().manual_seed(8),
        _t(pos_up), st["bitmap"][1], LR, LAM_U, LAM_I, LAM_B, shuffle=True,
        **kw)[0]
    rk, ks = port_bpr.draw_grouped_keys(
        torch.Generator().manual_seed(8), n_rounds, True)
    b = port_bpr.sgd_epoch_grouped_keyed(
        _params(3, u=10, i=33)[1], rk, ks, _t(pos_up), st["bitmap"][1], LR,
        LAM_U, LAM_I, LAM_B, **kw)[0]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="bloom membership requires pos_set"):
        port_bpr.sgd_epoch_grouped_keyed(
            b, rk, ks, _t(pos_up), st["bloom"][1], LR, LAM_U, LAM_I, LAM_B,
            **kw)


# --- the legacy epochs -------------------------------------------------------------

def _round_cands(key, rounds, b, n_items):
    """The candidates of qmf_tpu's _sample_negatives_impl(key): one split
    and one randint a round."""
    out = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(
            sub, (b,), 0, n_items, dtype=jnp.int32)))
    return np.stack(out)


@pytest.mark.parametrize("use_bitmap", [False, True])
def test_sample_negatives_impl_equal(use_bitmap):
    u, i = _positives(3, 300, 20, 15)
    st = _structures(u, i, 20, 15)
    users = np.random.default_rng(2).integers(0, 20, 512).astype(np.int32)
    key = jax.random.PRNGKey(1)
    js, ps = st["set"]
    jb, pb = st["bitmap"]
    want = jax_bpr._sample_negatives_impl(
        key, jnp.asarray(users), js.indptr, js.items, n_items=15, rounds=6,
        max_degree=js.max_degree,
        bitmap_words=jb.words if use_bitmap else None,
        wpu=jb.words_per_user if use_bitmap else 0)
    cands = _t(_round_cands(key, 6, 512, 15))
    got = port_bpr._sample_negatives_impl(
        cands, _t(users), ps.indptr, ps.items, ps.max_degree,
        bitmap_words=pb.words if use_bitmap else None,
        wpu=pb.words_per_user if use_bitmap else 0)
    _eq(got, want)
    # rows that collided in all 6 rounds keep the last candidate
    pairs = set(zip(u.tolist(), i.tolist()))
    hit = np.array([(a, b) in pairs for a, b in zip(users, got.numpy())])
    assert np.array_equal(got.numpy()[hit], cands[-1].numpy()[hit])


def test_sample_negatives_draws_from_generator():
    u, i = _positives(3, 100, 20, 15)
    ps = _structures(u, i, 20, 15)["set"][1]
    users = torch.arange(20, dtype=I32).repeat(20)
    neg = port_bpr.sample_negatives(
        torch.Generator().manual_seed(0), users, ps, 15, rounds=16)
    pairs = set(zip(u.tolist(), i.tolist()))
    assert neg.dtype == I32 and 0 <= int(neg.min()) and int(neg.max()) < 15
    assert not any((a, b) in pairs
                   for a, b in zip(users.tolist(), neg.tolist()))


@pytest.mark.parametrize("shuffle", [True, False])
def test_sample_pack_impl_equal(shuffle):
    u, i = _positives(6, 200, 20, 40)
    n = 256
    tri = np.zeros((n, 2), np.int32)
    tri[:200, 0], tri[:200, 1] = u, i
    jb, pb = _structures(u, i, 20, 40)["bitmap"]
    key = jax.random.PRNGKey(4)
    want = jax_bpr._sample_pack_impl(
        key, jnp.asarray(tri), jb.words, n_items=40, n_real=200,
        neg_rounds=4, shuffle=shuffle, wpu=jb.words_per_user)
    ks = None
    if shuffle:
        key, mkey = jax.random.split(key)
        ks = _t(_keys(mkey, (3,)))
    _, sub = jax.random.split(key)
    cands = _t(jax.random.randint(sub, (4, n), 0, 40, dtype=jnp.int32))
    got = port_bpr._sample_pack_impl(ks, cands, _t(tri), pb.words,
                                     n_real=200, wpu=pb.words_per_user)
    for g, w in zip(got, want):
        _eq(g, w)


def _legacy_stream(seed, n_real, n, n_users=20, n_items=40):
    u, i = _positives(seed, n_real, n_users, n_items)
    users = np.concatenate([u, np.zeros(n - n_real, np.int32)])
    items = np.concatenate([i, np.zeros(n - n_real, np.int32)])
    w = np.concatenate([np.ones(n_real), np.zeros(n - n_real)])
    return u, i, users, items, w


@pytest.mark.parametrize("shuffle", [True, False])
def test_sgd_epoch_impl_equal(shuffle):
    """Sampling inside each step over 4 steps, CSR membership, with the
    permutation and candidates qmf_tpu draws: within 1e-10 in float64."""
    bs, steps = 32, 4
    u, i, users, items, w = _legacy_stream(7, 120, bs * steps)
    js, ps = _structures(u, i, 20, 40)["set"]
    jp, pp = _params(4, u=20, i=40)
    key = jax.random.PRNGKey(9)
    want = jax_bpr._sgd_epoch_impl(
        jp, key, jnp.asarray(users), jnp.asarray(items), jnp.asarray(w),
        js.indptr, js.items, *(jnp.float64(x) for x in
                               (LR, LAM_U, LAM_I, LAM_B)),
        n_items=40, use_biases=True, neg_rounds=3,
        max_degree=js.max_degree, shuffle=shuffle, batch_size=bs)
    perm = None
    if shuffle:
        key, pkey = jax.random.split(key)
        perm = _t(jax.random.permutation(pkey, bs * steps))
    cands = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        cands.append(_round_cands(sub, 3, bs, 40))
    got = port_bpr._sgd_epoch_impl(
        pp, perm, _t(np.stack(cands)), _t(users), _t(items), _t(w),
        ps.indptr, ps.items, LR, LAM_U, LAM_I, LAM_B, use_biases=True,
        max_degree=ps.max_degree, batch_size=bs)
    assert _max_err(got, want) <= 1e-10


def _replay_sgd_epoch(key, n, n_items, neg_rounds, shuffle):
    """The draws of qmf_tpu's sgd_epoch(key) on its packed path."""
    _, skey = jax.random.split(key)
    ks = None
    if shuffle:
        skey, mkey = jax.random.split(skey)
        ks = _t(_keys(mkey, (3,)))
    _, sub = jax.random.split(skey)
    return ks, _t(jax.random.randint(sub, (neg_rounds, n), 0, n_items,
                                     dtype=jnp.int32))


def test_sgd_epoch_packed_equal():
    """sgd_epoch takes the packed presampled path (a bitmap, a power-of-two
    stream, n_real given): within 1e-10 in float64."""
    bs, n, n_real = 32, 128, 100
    u, i, users, items, w = _legacy_stream(8, n_real, n)
    st = _structures(u, i, 20, 40)
    jp, pp = _params(5, u=20, i=40)
    key = jax.random.PRNGKey(6)
    want = jax_bpr.sgd_epoch(
        jp, key, jnp.asarray(users), jnp.asarray(items), jnp.asarray(w),
        st["set"][0], *(jnp.float64(x) for x in (LR, LAM_U, LAM_I, LAM_B)),
        n_items=40, use_biases=True, neg_rounds=4, shuffle=True,
        batch_size=bs, bitmap=st["bitmap"][0], n_real=n_real)
    ks, cands = _replay_sgd_epoch(key, n, 40, 4, True)
    got = port_bpr.sgd_epoch_drawn(
        pp, ks, cands, _t(users), _t(items), _t(w), st["set"][1], LR, LAM_U,
        LAM_I, LAM_B, n_items=40, use_biases=True, batch_size=bs,
        bitmap=st["bitmap"][1], n_real=n_real)
    assert _max_err(got, want) <= 1e-10


@pytest.mark.parametrize("n,bs,bitmap,n_real,expect", [
    (100, 32, True, 100, "triplet stream length 100 not a power of two; "
                         "stream length 100 % batch_size 32 != 0"),
    (128, 32, False, 128, "no membership bitmap (over budget?)"),
    (128, 32, True, None, "n_real not provided"),
    (128, 32, True, 128, ""),
])
def test_sgd_epoch_choice_and_padding(n, bs, bitmap, n_real, expect):
    """The choice between the packed and the in-step epoch and its logged
    reasons; a stream the batch does not divide is padded with zero-weight
    rows that change nothing."""
    reasons = port_bpr.packed_path_reasons(n, 40, bs, bitmap, n_real)
    assert "; ".join(reasons) == expect
    assert port_bpr.packed_path_reasons(n, 1 << 16, bs, True, n)[0] == \
        f"n_items={1 << 16} > {1 << 15}"
    u, i, users, items, w = _legacy_stream(9, n, n)
    st = _structures(u, i, 20, 40)
    bm = st["bitmap"][1] if bitmap else None
    pp = _params(6, u=20, i=40)[1]
    before = [t.clone() for t in pp]
    got = port_bpr.sgd_epoch(
        pp, torch.Generator().manual_seed(1), _t(users), _t(items), _t(w),
        st["set"][1], LR, LAM_U, LAM_I, LAM_B, n_items=40, use_biases=False,
        neg_rounds=3, shuffle=True, batch_size=bs, bitmap=bm, n_real=n_real)
    assert all(torch.isfinite(t).all() for t in got)
    assert not torch.equal(got.user_factors, before[0])
    draw, cands = port_bpr.draw_epoch(
        torch.Generator().manual_seed(1), n, 40, 3, True, bs, not reasons)
    padded = n + (-n) % bs
    if reasons:
        assert sorted(draw.tolist()) == list(range(padded))
        assert cands.shape == (padded // bs, 3, bs)
        # the same epoch on a stream padded by hand with zero-weight rows
        pad = padded - n
        by_hand = port_bpr._sgd_epoch_impl(
            port_bpr.BPRParams(*(t.clone() for t in before)), draw, cands,
            *(torch.cat([_t(a), torch.zeros(pad, dtype=_t(a).dtype)])
              for a in (users, items, w)),
            st["set"][1].indptr, st["set"][1].items, LR, LAM_U, LAM_I, LAM_B,
            use_biases=False, max_degree=st["set"][1].max_degree,
            batch_size=bs)
        assert all(torch.equal(a, b) for a, b in zip(got, by_hand))
    else:
        assert draw.shape == (3,) and cands.shape == (3, n)


@pytest.mark.parametrize("use_biases", [False, True])
def test_eval_loss_equal(use_biases, monkeypatch):
    rng = np.random.default_rng(3)
    users = rng.integers(0, U, 500).astype(np.int32)
    pos = rng.integers(0, I, 500).astype(np.int32)
    neg = rng.integers(0, I, 500).astype(np.int32)
    jp, pp = _params(7)
    want = float(jax_bpr.eval_loss(
        jp, jnp.asarray(users), jnp.asarray(pos), jnp.asarray(neg),
        use_biases=use_biases))
    got = port_bpr.eval_loss(pp, _t(users), _t(pos), _t(neg), use_biases)
    assert got.shape == () and abs(float(got) - want) <= 1e-12
    # scored in chunks, the mean is the same
    monkeypatch.setattr(port_bpr, "_EVAL_CHUNK", 64)
    chunked = port_bpr.eval_loss(pp, _t(users), _t(pos), _t(neg), use_biases)
    assert abs(float(chunked) - want) <= 1e-12


def test_sample_negatives_host_equal():
    users = np.array([0, 0, 1] * 50)
    items = np.array([0, 1, 2] * 50)
    want = jax_bpr.sample_negatives_host(
        np.random.default_rng(0), users, users, items, 4)
    got = port_bpr.sample_negatives_host(
        np.random.default_rng(0), users, users, items, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", [
    (138_493, 26_744, 3, 4, 32768, True), (100, 100, 3, 4, 64, False),
    (100, 100, 0, 4, 64, True), (100, 100, 16, 4, 64, True),
    (100, 100, 15, 4, 64, True), (100, 100, 1, 0, 64, True),
    (100, 100, 1, 5, 64, True), (100, 100, 3, 4, 0, True),
    (100, 100, 3, 4, 96, True), (1 << 25, 100, 3, 4, 64, True),
    (100, 1 << 31, 3, 4, 64, True),
])
def test_grouped_path_reject_reason_equal(args):
    assert port_bpr.grouped_path_reject_reason(*args) == \
        jax_bpr.grouped_path_reject_reason(*args)


def test_membership_beyond_int32_key_range():
    """user * n_items + item would overflow int32; the CSR search must not
    care (tests/test_bpr.py's case, both packages)."""
    users = np.array([0, 2, 2], dtype=np.int64)
    items = np.array([5, 1_999_999_999, 7], dtype=np.int64)
    q_u = np.array([2, 2, 0, 1], dtype=np.int32)
    q_i = np.array([1_999_999_999, 42, 5, 5], dtype=np.int32)
    want = jax_bpr._is_member(jax_bpr.make_pos_set(users, items, 3),
                              jnp.asarray(q_u), jnp.asarray(q_i))
    got = port_bpr._is_member(
        port_bpr.make_pos_set(users, items, 3, device="cpu"), _t(q_u),
        _t(q_i))
    _eq(got, want)
    assert got.tolist() == [True, False, True, False]
