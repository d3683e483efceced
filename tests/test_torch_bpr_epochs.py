"""BPR's epochs as the one-program functions a card captures, on the CPU.

- The fixed-capacity compaction of the presampler (``_compact``) and the
  presamplers built on it against qmf_tpu's (``jnp.where(..., size=...)``)
  bit for bit, overflowing buffers included.
- The whole grouped epoch (``grouped_epoch``: pass 1 and the SGD loop as
  one function) against the two-part composition it replaces: pass 1 with
  the compaction that read its count through ``torch.nonzero`` (kept here
  as the reference), then the loop; ``torch.equal``, float64 and float32.
- The legacy epochs with the rate as a 0-d tensor (``packed_epoch``, the
  steps of ``instep_step``) against qmf_tpu's within 1e-9 in float64.
- ``graphs.NoHostReads`` around each function a card captures: no host
  read of a device value, no output whose shape depends on the data.
- The engine's programs through an EpochGraph whose capture and replay
  run on the CPU (a stand-in): its static buffers fed back, the in-step
  graph replayed once a step, equal to the eager engine bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qmf_tpu.ops import bpr_ops as jax_bpr
from qmf_tpu_torch.config import BPRConfig
from qmf_tpu_torch.data import Dataset
from qmf_tpu_torch.models import BPREngine
from qmf_tpu_torch.ops import bpr_ops as port_bpr
from qmf_tpu_torch.ops import graphs

LR, LAM_U, LAM_I, LAM_B = 0.05, 0.025, 0.0025, 1.0


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _keys(key, shape):
    """qmf_tpu's key draw: int32 in [0, 2^30)."""
    return jax.random.randint(key, shape, 0, 1 << 30, dtype=jnp.int32)


def _positives(seed, n, n_users, n_items):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, n).astype(np.int32),
            rng.integers(0, n_items, n).astype(np.int32))


def _structures(u, i, n_users, n_items, bloom_bits=64):
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


def _compact_nonzero(mask, cap):
    """The compaction the fixed buffer replaced, kept as the reference:
    the first ``cap`` set positions through ``torch.nonzero`` (whose shape
    waits for the device), and the count beyond ``cap``."""
    cidx = torch.nonzero(mask).squeeze(1)[:cap].to(torch.int32)
    return cidx, torch.clamp(mask.sum(dtype=torch.int32) - cap, min=0)


# --- the fixed-capacity compaction ---------------------------------------------

@pytest.mark.parametrize("p_set", [0.0, 0.03, 0.5, 1.0])
@pytest.mark.parametrize("cap", [1, 37, 400, 5000])
def test_compact_equals_jnp_where(cap, p_set):
    """``_compact`` is qmf_tpu's ``jnp.where(mask, size=cap,
    fill_value=n)`` bit for bit (fill rows included), and its overflow
    count qmf_tpu's; the set positions are the nonzero compaction's."""
    n = 4000
    mask = np.random.default_rng(cap).random(n) < p_set
    cidx, over = port_bpr._compact(_t(mask), cap)
    (want,) = jnp.where(jnp.asarray(mask), size=cap, fill_value=n)
    assert cidx.dtype == torch.int32 and cidx.shape == (cap,)
    np.testing.assert_array_equal(cidx.numpy(), np.asarray(want))
    assert over.dtype == torch.int32 and over.shape == ()
    assert int(over) == max(int(mask.sum()) - cap, 0)
    ref, ref_over = _compact_nonzero(_t(mask), cap)
    assert torch.equal(cidx[: ref.shape[0]], ref)
    assert bool((cidx[ref.shape[0]:] == n).all()) and int(over) == int(ref_over)


@pytest.mark.parametrize("n_rounds", [1, 2, 4])
@pytest.mark.parametrize("membership", ["rounds", "bloom"])
def test_sample_rounds_equal_qmf_tpu_at_every_cap(membership, n_rounds):
    """The presamplers on the fixed buffer against qmf_tpu's, with the
    buffer larger than, equal to and smaller than the colliders (those
    beyond it keep round 0, counted in n_overflow), bit for bit."""
    u, i = _positives(11, 500, 30, 24)
    st = _structures(u, i, 30, 24)
    users = np.random.default_rng(2).integers(0, 30, 1500).astype(np.int32)
    rk = _keys(jax.random.PRNGKey(3), (n_rounds, 3))
    if membership == "bloom":
        hit = port_bpr._is_member_bloom(
            st["bloom"][1], _t(users),
            port_bpr._cand_hash(_t(rk[0]), torch.arange(1500, dtype=torch.int32),
                                24))
    else:
        hit = port_bpr._is_member_bitmap(
            st["bitmap"][1], _t(users),
            port_bpr._cand_hash(_t(rk[0]), torch.arange(1500, dtype=torch.int32),
                                24))
    colliders = int(hit.sum())
    assert colliders > 20
    for cap in (colliders + 50, colliders, colliders - 1, 7):
        if membership == "bloom":
            want, want_over = jax_bpr._sample_rounds_bloom(
                rk, jnp.asarray(users), st["bloom"][0], st["set"][0], 24,
                n_rounds, cap)
            got, over = port_bpr._sample_rounds_bloom(
                _t(rk), _t(users), st["bloom"][1], st["set"][1], 24,
                n_rounds, cap)
        else:
            want, want_over = jax_bpr._sample_rounds(
                rk, jnp.asarray(users), st["bitmap"][0], 24, n_rounds, cap)
            got, over = port_bpr._sample_rounds(
                _t(rk), _t(users), st["bitmap"][1], 24, n_rounds, cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32
        assert int(over) == int(want_over)
        if n_rounds > 1 or membership == "bloom":
            assert int(over) == max(colliders - cap, 0)


def _grouped_setup(membership, n_pos=600, bs=64, n_users=40, n_items=48,
                   seed=5):
    u, i = _positives(seed, n_pos, n_users, n_items)
    pad = (-n_pos) % bs
    pos_up = np.stack([np.concatenate([u, np.zeros(pad, np.int32)]),
                       np.concatenate([i, np.zeros(pad, np.int32)])], axis=1)
    st = _structures(u, i, n_users, n_items, bloom_bits=128)
    return pos_up, st, n_pos, n_items


@pytest.mark.parametrize("collide_cap", [4096, 40])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("membership", ["word", "bitmap", "bloom"])
def test_grouped_pass1_equals_qmf_tpu(membership, shuffle, collide_cap):
    """Pass 1 of the grouped epoch (shuffle, presample, pack) on qmf_tpu's
    draws: the packed stream and the overflow count bit for bit, a buffer
    of 40 slots overflowing for the compacted samplers."""
    num_neg, n_rounds, bs = 3, 4, 64
    pos_up, st, n_real, n_items = _grouped_setup(membership)
    words = st["bloom" if membership == "bloom" else "bitmap"]
    csr = membership == "bloom"
    kw = dict(n_items=n_items, n_real=n_real, num_neg=num_neg,
              n_rounds=n_rounds, wpu=words[0].words_per_user,
              u_shift=1 + 2 * num_neg, feistel_b=6, collide_cap=collide_cap,
              membership=membership, max_degree=st["set"][0].max_degree)
    key = jax.random.PRNGKey(8)
    want = jax_bpr._sample_pack_grouped_impl(
        key, jnp.asarray(pos_up), words[0].words, shuffle=shuffle,
        indptr=st["set"][0].indptr if csr else None,
        csr_items=st["set"][0].items if csr else None, **kw)
    key2, rkey = jax.random.split(key)
    rk = _t(_keys(rkey, (n_rounds, 3)))
    ks = _t(_keys(jax.random.split(key2)[1], (6,))) if shuffle else None
    got = port_bpr._sample_pack_grouped_body(
        rk, ks, _t(pos_up), words[1].words,
        indptr=st["set"][1].indptr if csr else None,
        csr_items=st["set"][1].items if csr else None, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[3])
    if membership != "word":
        assert (int(got[2]) > 0) == (collide_cap == 40)


def _params(seed, dtype, n_users, n_items, k=8):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(0, 0.3, (n_users, k)), rng.normal(0, 0.3, (n_items, k)),
            rng.normal(0, 0.3, n_items))
    return (jax_bpr.BPRParams(*(jnp.asarray(a, dtype) for a in arrs)),
            port_bpr.BPRParams(*(torch.tensor(a, dtype=torch.from_numpy(
                np.zeros(1, dtype)).dtype) for a in arrs)))


def _grouped_kw(membership, st, n_real, n_items, collide_cap, use_biases):
    return dict(
        bitmap=st["bloom" if membership == "bloom" else "bitmap"][1],
        user_lambda=LAM_U, item_lambda=LAM_I, bias_lambda=LAM_B,
        n_items=n_items, n_real=n_real, use_biases=use_biases, num_neg=3,
        neg_rounds=4, batch_size=64, collide_cap=collide_cap,
        pos_set=st["set"][1] if membership == "bloom" else None,
        item_scatter="seq",
        sampler="word" if membership == "word" else "rounds")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("membership,shuffle,collide_cap,use_biases", [
    ("word", True, 4096, True), ("word", False, 4096, False),
    ("bitmap", True, 4096, False), ("bitmap", True, 40, True),
    ("bloom", True, 4096, True), ("bloom", False, 40, False),
])
def test_whole_grouped_epoch_equals_two_part_composition(
        monkeypatch, membership, shuffle, collide_cap, use_biases, dtype):
    """``grouped_epoch``'s one function against what the engine ran
    before: pass 1 with the nonzero compaction, then the SGD loop of
    ``grouped_sgd``, on the same keys for three epochs, the rate a 0-d
    tensor decaying: parameters and overflow counts ``torch.equal``."""
    pos_up, st, n_real, n_items = _grouped_setup(membership)
    kw = _grouped_kw(membership, st, n_real, n_items, collide_cap,
                     use_biases)
    got = _params(1, dtype, 40, n_items)[1]
    want = port_bpr.BPRParams(*(t.clone() for t in got))
    epoch = port_bpr.grouped_epoch(_t(pos_up), shuffle=shuffle, **kw)
    sgd = port_bpr.grouped_sgd(
        kw["bitmap"], LAM_U, LAM_I, LAM_B, use_biases, 64, 3, n_items, 4,
        "seq", kw["sampler"])
    bitmap = kw["bitmap"]
    use_word = membership == "word"
    gen = torch.Generator().manual_seed(4)
    overflow = []
    for e in range(3):
        rk, ks = port_bpr.draw_grouped_keys(gen, 4, shuffle)
        lr = torch.tensor(LR * 0.9 ** e, dtype=got.user_factors.dtype)
        *new, over = epoch(rk, port_bpr.no_keys(6, "cpu") if ks is None
                           else ks, lr, *got)
        assert all(a is b for a, b in zip(new, got))  # in place
        with monkeypatch.context() as m:
            m.setattr(port_bpr, "_compact", _compact_nonzero)
            enc, p, ref_over = port_bpr._sample_pack_grouped_body(
                rk, ks, _t(pos_up), bitmap.words, n_items=n_items,
                n_real=n_real, num_neg=3, n_rounds=4,
                wpu=bitmap.words_per_user, u_shift=7, feistel_b=6,
                collide_cap=collide_cap,
                membership="word" if use_word else membership,
                indptr=st["set"][1].indptr, csr_items=st["set"][1].items,
                max_degree=st["set"][1].max_degree)
        sgd(enc, p, rk, lr, *want)
        overflow.append((int(over), int(ref_over)))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(a == b for a, b in overflow)
    if collide_cap == 40:
        assert all(a > 0 for a, _ in overflow)


# --- the legacy epochs ---------------------------------------------------------

def _legacy(seed, n_real, n, n_users=20, n_items=40):
    u, i = _positives(seed, n_real, n_users, n_items)
    users = np.concatenate([u, np.zeros(n - n_real, np.int32)])
    items = np.concatenate([i, np.zeros(n - n_real, np.int32)])
    w = np.concatenate([np.ones(n_real), np.zeros(n - n_real)])
    return u, i, users, items, w


@pytest.mark.parametrize("use_biases", [False, True])
@pytest.mark.parametrize("shuffle", [True, False])
def test_packed_epoch_with_a_tensor_rate_matches_qmf_tpu(shuffle, use_biases):
    """``packed_epoch`` (pass 1 + every step as one function) with the rate
    a 0-d float64 tensor, on qmf_tpu's draws, against qmf_tpu's sgd_epoch
    on its packed path: within 1e-9 over three epochs."""
    bs, n, n_real = 32, 256, 230
    u, i, users, items, w = _legacy(8, n_real, n)
    st = _structures(u, i, 20, 40)
    jp, pp = _params(5, np.float64, 20, 40)
    epoch = port_bpr.packed_epoch(
        torch.stack([_t(users), _t(items)], dim=1), st["bitmap"][1], n_real,
        LAM_U, LAM_I, LAM_B, use_biases, bs, shuffle)
    for e in range(3):
        key = jax.random.PRNGKey(20 + e)
        lr = LR * 0.9 ** e
        jp = jax_bpr.sgd_epoch(
            jp, key, jnp.asarray(users), jnp.asarray(items), jnp.asarray(w),
            st["set"][0], *(jnp.float64(x) for x in (lr, LAM_U, LAM_I, LAM_B)),
            n_items=40, use_biases=use_biases, neg_rounds=4, shuffle=shuffle,
            batch_size=bs, bitmap=st["bitmap"][0], n_real=n_real)
        _, skey = jax.random.split(key)
        ks = port_bpr.no_keys(3, "cpu")
        if shuffle:
            skey, mkey = jax.random.split(skey)
            ks = _t(_keys(mkey, (3,)))
        cands = _t(jax.random.randint(jax.random.split(skey)[1], (4, n), 0,
                                      40, dtype=jnp.int32))
        epoch(ks, cands, torch.tensor(lr, dtype=torch.float64), *pp)
    for got, want in zip(pp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-9)


@pytest.mark.parametrize("use_biases", [False, True])
@pytest.mark.parametrize("shuffle", [True, False])
def test_instep_steps_with_a_tensor_rate_match_qmf_tpu(shuffle, use_biases):
    """The in-step epoch as ``instep_step`` run once a step
    (graphs.run_steps), its step index a device scalar and the rate a 0-d
    float64 tensor, on qmf_tpu's permutation and candidates, against
    qmf_tpu's ``_sgd_epoch_impl`` (its lax.scan): within 1e-9."""
    bs, steps = 24, 5
    u, i, users, items, w = _legacy(7, 110, bs * steps)
    js, ps = _structures(u, i, 20, 40)["set"]
    jp, pp = _params(4, np.float64, 20, 40)
    step = port_bpr.instep_step(
        _t(users), _t(items), _t(w), ps.indptr, ps.items, LAM_U, LAM_I,
        LAM_B, use_biases, ps.max_degree, bs)
    for e in range(2):
        key = jax.random.PRNGKey(9 + e)
        lr = LR * 0.9 ** e
        jp = jax_bpr._sgd_epoch_impl(
            jp, key, jnp.asarray(users), jnp.asarray(items), jnp.asarray(w),
            js.indptr, js.items,
            *(jnp.float64(x) for x in (lr, LAM_U, LAM_I, LAM_B)),
            n_items=40, use_biases=use_biases, neg_rounds=3,
            max_degree=js.max_degree, shuffle=shuffle, batch_size=bs)
        perm = port_bpr.stream_rows(bs * steps, "cpu")
        if shuffle:
            key, pkey = jax.random.split(key)
            perm = _t(jax.random.permutation(pkey, bs * steps), torch.int32)
        cands = []
        for _ in range(steps):
            key, sub = jax.random.split(key)
            rounds = []
            for _ in range(3):
                sub, r = jax.random.split(sub)
                rounds.append(np.asarray(jax.random.randint(
                    r, (bs,), 0, 40, dtype=jnp.int32)))
            cands.append(np.stack(rounds))
        t = torch.zeros((), dtype=torch.int64)
        out = graphs.run_steps(
            step, (t, perm, _t(np.stack(cands)),
                   torch.tensor(lr, dtype=torch.float64), *pp), steps)
        assert out[0] is t and int(t) == steps
    for got, want in zip(pp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-9)


# --- no host reads in what a card captures ---------------------------------------

@pytest.mark.parametrize("membership", ["word", "bitmap", "bloom"])
def test_grouped_epoch_reads_nothing_on_the_host(membership):
    """The whole grouped epoch under graphs.NoHostReads, a buffer small
    enough to overflow included; the nonzero compaction it replaced is
    refused."""
    pos_up, st, n_real, n_items = _grouped_setup(membership)
    kw = _grouped_kw(membership, st, n_real, n_items, 40, True)
    epoch = port_bpr.grouped_epoch(_t(pos_up), shuffle=True, **kw)
    params = _params(1, np.float32, 40, n_items)[1]
    rk, ks = port_bpr.draw_grouped_keys(torch.Generator().manual_seed(2), 4,
                                        True)
    lr = torch.tensor(LR)
    with graphs.NoHostReads():
        *_, over = epoch(rk, ks, lr, *params)
    if membership != "word":
        assert int(over) > 0
        with pytest.raises(RuntimeError, match="nonzero"):
            with graphs.NoHostReads():
                _compact_nonzero(torch.ones(8, dtype=torch.bool), 4)


def test_legacy_programs_read_nothing_on_the_host():
    """The packed legacy epoch and one in-step step under
    graphs.NoHostReads; a float rate outside the program stays allowed."""
    bs, n, n_real = 32, 128, 100
    u, i, users, items, w = _legacy(3, n_real, n)
    st = _structures(u, i, 20, 40)
    params = _params(2, np.float32, 20, 40)[1]
    gen = torch.Generator().manual_seed(0)
    lr = torch.tensor(LR)
    packed = port_bpr.packed_epoch(
        torch.stack([_t(users), _t(items)], dim=1), st["bitmap"][1], n_real,
        LAM_U, LAM_I, LAM_B, True, bs, True)
    ks, cands = port_bpr.draw_epoch(gen, n, 40, 4, True, bs, True)
    with graphs.NoHostReads():
        packed(ks, cands, lr, *params)
    ps = st["set"][1]
    step = port_bpr.instep_step(
        _t(users), _t(items), _t(w, torch.float32), ps.indptr, ps.items,
        LAM_U, LAM_I, LAM_B, True, ps.max_degree, bs)
    perm, cands = port_bpr.draw_epoch(gen, n, 40, 4, True, bs, False)
    t = torch.zeros((), dtype=torch.int64)
    with graphs.NoHostReads():
        graphs.run_steps(step, (t, perm, cands, lr, *params), n // bs)
    assert int(t) == n // bs


# --- the engine's programs through an EpochGraph ---------------------------------

def _stand_in_capture(self, inputs):
    """EpochGraph._capture on the CPU: the warm-up runs the body on clones
    of the inputs (the static buffers); the capture launches nothing, so
    the statics are left as the warm-up left them; a replay runs the body
    on the statics and writes what it returns into the static outputs."""
    self._inputs = [t.clone() for t in inputs]
    warm = self._fn(*self._inputs)
    self._outputs = tuple(o.clone() if not any(o is s for s in self._inputs)
                          else o for o in warm)
    self._delta = [0] * len(self._counts())
    self.record_s = self.instantiate_s = 0.0
    graph = self

    class _Replay:
        @staticmethod
        def replay():
            for out, new in zip(graph._outputs, graph._fn(*graph._inputs)):
                if out is not new:
                    out.copy_(new)

    self._graph = _Replay
    return warm


def _bpr_data(n_users=30, n_items=40, n=500, seed=0):
    rng = np.random.default_rng(seed)
    return Dataset(rng.integers(1, n_users + 1, n),
                   rng.integers(100, 100 + n_items, n), np.ones(n))


@pytest.mark.parametrize("kw,path,n", [
    (dict(), "grouped", 500),
    # 3,000 rows over 30 x 40 ids: most candidates collide, and the
    # engine's buffer (half the slots) overflows
    (dict(neg_sampler="rounds"), "grouped", 3000),
    (dict(shuffle_training_set=False, use_biases=True), "grouped", 500),
    (dict(grouped_epoch=False), "packed", 500),
    (dict(grouped_epoch=False, batch_size=48), "instep", 500),
    (dict(grouped_epoch=False, batch_size=48, shuffle_training_set=False),
     "instep", 500),
], ids=["word", "rounds-overflow", "noshuffle", "packed", "instep",
        "instep-noshuffle"])
def test_engine_programs_replay_as_eager(monkeypatch, kw, path, n):
    """BPREngine with its epoch program an EpochGraph (the up-front rule
    told there is no reason to run eagerly; the capture a CPU stand-in)
    against the same engine run eagerly: every path's parameters bit for
    bit after three epochs, the grouped overflow counts alike, the in-step
    graph called once a step and replayed on its own buffers."""
    cfg = {**dict(nepochs=3, nfactors=6, batch_size=64, init_seed=3), **kw}
    runs = {}
    for graphed in (True, False):
        with monkeypatch.context() as m:
            if graphed:
                m.setattr(graphs, "eager_reasons", lambda *a, **k: [])
                m.setattr(graphs.EpochGraph, "_capture", _stand_in_capture)
            eng = BPREngine(BPRConfig(**cfg), device="cpu")
            eng.init(_bpr_data(n=n))
            eng.optimize()
        runs[graphed] = eng
    graph, eager = runs[True], runs[False]
    assert isinstance(graph._program, graphs.EpochGraph)
    assert not isinstance(eager._program, graphs.EpochGraph)
    assert path == ("grouped" if graph._grouped else "packed"
                    if graph._legacy_packed() else "instep")
    calls = 3 * (graph._tri_users.shape[0] // 48 if path == "instep" else 1)
    assert graph._program.replays == calls - 1
    # the engine's parameters are the graph's static buffers
    assert all(a is b for a, b in zip(graph.params,
                                      graph._program.inputs[-3:]))
    for a, b in zip(graph.params, eager.params):
        assert torch.equal(a, b)
    assert graph.overflow_slots == eager.overflow_slots
    assert (eager.overflow_slots > 0) == (n == 3000)
