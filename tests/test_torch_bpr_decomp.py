"""tools/bpr_decomp.py held against qmf_tpu on the CPU, at small sizes.

Two engines, the port's ``BPREngine`` and qmf_tpu's, take the same few
hundred positives (50 users, 75 items: the last bitmap word has a tail) at
batch 128 and the tool's configuration (3 negatives, 4 rounds), on the
exact bitmap and, with ``bitmap_budget_mb=0``, on the Bloom filter with
the CSR check. qmf_tpu's functions draw inside (``jax.random``); the tests
replay those draws and hand the port the same integers:

- each stage prefix of pass 1 (shuffle, member0, compact, rounds, full,
  word) equals the prefix benchmarks/bpr_presample_micro.py builds from
  qmf_tpu's helpers, ``torch.equal`` on int32;
- pass 1 then the SGD loop (bpr_ops.grouped_parts, as the tool runs them)
  equal qmf_tpu's ``_sample_pack_grouped_body`` then
  ``_sgd_epoch_scan_grouped_body`` in float64 within 1e-10, and the
  engine's epoch program bit for bit (``split_check``; on the CPU each
  program is its eager body);
- ``decompose`` and ``main(["--device=cpu", ...])`` give every part
  finite, and without a card the tool exits nonzero.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmf_tpu.config import BPRConfig as JaxBPRConfig
from qmf_tpu.data.dataset import Dataset as JaxDataset
from qmf_tpu.models.bpr import BPREngine as JaxBPREngine
from qmf_tpu.ops import bpr_ops as jax_bpr
from qmf_tpu_torch.data import Dataset
from qmf_tpu_torch.models import BPREngine
from qmf_tpu_torch.ops import bpr_ops
from qmf_tpu_torch.tools import bpr_decomp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, NUM_NEG, N_ROUNDS = 128, 3, 4
N_USERS, N_ITEMS, N_POS = 50, 75, 600
TOL = 1e-10


def _ratings(seed=5):
    """A few hundred positives over every user and item (ids from 1)."""
    rng = np.random.default_rng(seed)
    u = np.concatenate([np.arange(N_USERS),
                        rng.integers(0, N_USERS, N_POS - N_USERS)])
    i = np.concatenate([np.arange(N_ITEMS),
                        rng.integers(0, N_ITEMS, N_POS - N_ITEMS)])[:N_POS]
    return u + 1, i + 1, np.ones(N_POS)


def _engines(membership, dtype="float64"):
    """(port engine, qmf_tpu engine) on the same ratings; ``membership``
    "word" (the default sampler), "rounds" (the compacted sampler on the
    bitmap) or "bloom"."""
    bloom = membership == "bloom"
    sampler = "rounds" if membership == "rounds" else "word"
    users, items, values = _ratings()
    eng = BPREngine(bpr_decomp.bpr_config(BATCH, bloom, dtype=dtype,
                                          neg_sampler=sampler),
                    device="cpu")
    eng.init(Dataset(users, items, values))
    jax_eng = JaxBPREngine(JaxBPRConfig(
        nepochs=1, nfactors=30, num_negative_samples=NUM_NEG,
        batch_size=BATCH, neg_resample_rounds=N_ROUNDS, init_seed=0,
        neg_sampler=sampler, **({"bitmap_budget_mb": 0} if bloom else {})))
    jax_eng.init(JaxDataset(users, items, values))
    assert eng._grouped and jax_eng._grouped
    assert (eng._pos_bloom is not None) == bloom == (jax_eng._pos_bitmap
                                                     is None)
    np.testing.assert_array_equal(eng._grp_up.numpy(),
                                  np.asarray(jax_eng._grp_up))
    assert eng._collide_cap == jax_eng._collide_cap
    return eng, jax_eng


def _keys(key, shape):
    return jax.random.randint(key, shape, 0, 1 << 30, dtype=jnp.int32)


def _replayed(key):
    """The (rk, ks) that qmf_tpu's ``_sample_pack_grouped_body(key, ...,
    shuffle=True)`` draws, as tensors."""
    key2, rkey = jax.random.split(key)
    _, mkey = jax.random.split(key2)
    return (torch.tensor(np.asarray(_keys(rkey, (N_ROUNDS, 3)))),
            torch.tensor(np.asarray(_keys(mkey, (6,)))))


def _jax_pack(jax_eng, key, membership):
    """qmf_tpu's pass 1 on ``key``: (enc, p, rk, n_overflow)."""
    bloom = jax_eng._pos_bitmap is None
    member = jax_eng._pos_bloom if bloom else jax_eng._pos_bitmap
    return jax_bpr._sample_pack_grouped_body(
        key, jax_eng._grp_up, member.words, n_items=jax_eng.nitems,
        n_real=jax_eng._n_real_pos, num_neg=NUM_NEG, n_rounds=N_ROUNDS,
        shuffle=True, wpu=member.words_per_user, u_shift=1 + 2 * NUM_NEG,
        feistel_b=jax_eng._grp_batch.bit_length() - 1,
        collide_cap=jax_eng._collide_cap, membership=membership,
        indptr=jax_eng._pos_set.indptr if bloom else None,
        csr_items=jax_eng._pos_set.items if bloom else None,
        max_degree=jax_eng._pos_set.max_degree if bloom else 0)


def _jax_stage(jax_eng, key, stage):
    """benchmarks/bpr_presample_micro.py's ``staged`` prefix on qmf_tpu's
    helpers (its ``word_full`` for "word", the production pass 1 for
    "full"), on the Bloom filter with the CSR check where the engine has
    no bitmap (``_sample_rounds_bloom``'s composition): (enc, p)."""
    bloom = jax_eng._pos_bitmap is None
    if stage in ("full", "word"):
        membership = "word" if stage == "word" else (
            "bloom" if bloom else "bitmap")
        return _jax_pack(jax_eng, key, membership)[:2]
    member = jax_eng._pos_bloom if bloom else jax_eng._pos_bitmap
    is_member = jax_bpr._is_member_bloom if bloom else \
        jax_bpr._is_member_bitmap
    n_items, n_real = jax_eng.nitems, jax_eng._n_real_pos
    n_stream = jax_eng._grp_up.shape[0]
    feistel_b = jax_eng._grp_batch.bit_length() - 1
    key, rkey = jax.random.split(key)
    rk = _keys(rkey, (N_ROUNDS, 3))
    key, mkey = jax.random.split(key)
    idx = jax_bpr._feistel_bijection(mkey, n_stream >> feistel_b, feistel_b)
    u = jax_eng._grp_users[idx]
    p = jax_eng._grp_items[idx]
    enc = (u << (1 + 2 * NUM_NEG)) | (idx < n_real).astype(jnp.int32)
    if stage == "shuffle":
        return enc, p
    users_slots = jnp.repeat(u, NUM_NEG)
    n = users_slots.shape[0]
    f = jnp.arange(n, dtype=jnp.int32)
    member0 = is_member(member, users_slots,
                        jax_bpr._cand_hash(rk[0], f, n_items))
    if stage == "member0":
        return enc | member0.reshape(n_stream, NUM_NEG)[:, 0], p
    (cidx,) = jnp.where(member0, size=jax_eng._collide_cap, fill_value=n)
    if stage == "compact":
        return enc | (jnp.sum(cidx) & 1), p
    cf = jnp.where(cidx < n, cidx, 0)
    cu = users_slots[cf]
    if bloom:
        def test(users, cand):
            return jax_bpr._is_member(jax_eng._pos_set, users, cand)

        m0 = test(cu, jax_bpr._cand_hash(rk[0], cf, n_items))
        chosen = jnp.where(m0, N_ROUNDS - 1, 0).astype(jnp.int32)
        found = ~m0
    else:
        def test(users, cand):
            return jax_bpr._is_member_bitmap(member, users, cand)

        chosen = jnp.full(cidx.shape, N_ROUNDS - 1, jnp.int32)
        found = jnp.zeros(cidx.shape, bool)
    for r in range(1, N_ROUNDS):
        m_r = test(cu, jax_bpr._cand_hash(rk[r], cf, n_items))
        take = (~found) & (~m_r)
        chosen = jnp.where(take, r, chosen)
        found = found | take
    assert stage == "rounds"
    return enc | (jnp.sum(chosen) & 1), p


def _as_int32(a):
    """A jax integer array as an int32 tensor (the micro's ``jnp.sum``
    widens to int64 under x64; every value fits)."""
    a = np.asarray(a)
    assert a.min() >= np.iinfo(np.int32).min and a.max() <= np.iinfo(
        np.int32).max
    return torch.tensor(a.astype(np.int32))


@pytest.mark.parametrize("membership", ["word", "bloom"])
def test_stage_prefixes_equal_qmf_tpu(membership):
    """Every stage of the tool on qmf_tpu's replayed draws: torch.equal to
    the micro's prefix; the stages' outputs differ where they should."""
    eng, jax_eng = _engines(membership)
    parts = bpr_ops.grouped_parts(*eng._grouped_args())
    key = jax.random.PRNGKey(3)
    rk, ks = _replayed(key)
    stages = bpr_decomp.stage_names(eng)
    assert ("word" in stages) == (membership != "bloom")
    outs = {}
    for stage in stages:
        got = bpr_decomp.stage_fn(eng, parts.pack, stage)(rk, ks)
        want = _jax_stage(jax_eng, key, stage)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            assert torch.equal(g, _as_int32(w)), stage
        outs[stage] = got[0]
    assert not torch.equal(outs["shuffle"], outs["full"])
    assert not torch.equal(outs["member0"], outs["shuffle"])
    # the engine's own pass 1 is the full pass 1 of its membership
    enc, _, _ = parts.pass1(rk, ks)
    assert torch.equal(enc, outs["word" if membership == "word"
                                 else "full"])


@pytest.mark.parametrize("membership", ["word", "rounds", "bloom"])
def test_pass1_then_loop_equal_qmf_tpu(membership):
    """grouped_parts' pass 1 and SGD loop on qmf_tpu's draws: the packed
    stream bit for bit, the parameters in float64 within 1e-10 of
    qmf_tpu's two programs."""
    eng, jax_eng = _engines(membership)
    parts = bpr_ops.grouped_parts(*eng._grouped_args())
    key = jax.random.PRNGKey(9)
    rk, ks = _replayed(key)
    enc, p, over = parts.pass1(rk, ks)
    j_membership = {"word": "word", "rounds": "bitmap", "bloom": "bloom"}[
        membership]
    j_enc, j_p, j_rk, j_over = _jax_pack(jax_eng, key, j_membership)
    assert torch.equal(enc, _as_int32(j_enc))
    assert torch.equal(p, _as_int32(j_p))
    assert torch.equal(rk, _as_int32(j_rk))
    assert int(over) == int(j_over)
    rng = np.random.default_rng(1)
    arrs = (rng.normal(0, 0.3, (eng.nusers, 30)),
            rng.normal(0, 0.3, (eng.nitems, 30)), np.zeros(eng.nitems))
    params = [torch.tensor(a) for a in arrs]
    cfg = eng.config
    lr = 0.05
    got = parts.sgd(enc, p, rk, torch.tensor(lr, dtype=torch.float64),
                    *params)
    want = jax_bpr._sgd_epoch_scan_grouped_body(
        jax_bpr.BPRParams(*(jnp.asarray(a) for a in arrs)), j_enc, j_p,
        j_rk, jnp.float64(lr), jnp.float64(cfg.user_lambda),
        jnp.float64(cfg.item_lambda), jnp.float64(cfg.bias_lambda),
        use_biases=cfg.use_biases, batch_size=BATCH, num_neg=NUM_NEG,
        n_items=eng.nitems, n_rounds=N_ROUNDS, u_shift=1 + 2 * NUM_NEG,
        item_scatter=cfg.item_scatter,
        sampler="word" if membership == "word" else "rounds",
        wpu=eng._pos_bitmap.words_per_user if membership == "word" else 0)
    moved = 0.0
    for g, w, a in zip(got, want, arrs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)
        moved = max(moved, float(np.abs(g.numpy() - a).max()))
    assert moved > 1e-4


@pytest.mark.parametrize("membership", ["word", "rounds", "bloom"])
def test_split_equals_one_epoch_call(membership):
    """split_check on the CPU: pass 1 then the loop give the parameters of
    one grouped_epoch call on the same keys bit for bit, in float32, and
    leave the engine's parameters as they were."""
    eng, _ = _engines(membership, dtype="float32")
    before = [t.clone() for t in eng.params]
    got = bpr_decomp.split_check(eng)
    assert got == {"equal": True, "max_abs_diff": 0.0, "n_overflow": 0,
                   "nodes": dict.fromkeys(("pass 1", "SGD loop",
                                           "BPR grouped epoch"))}
    assert all(torch.equal(a, b) for a, b in zip(eng.params, before))
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("batch,bloom", [(256, False), (128, True),
                                         (64, False)])
def test_init_like_equals_init(batch, bloom):
    """An engine initialized by bpr_decomp.init_like from another (batch
    128, exact bitmap) holds what ``init`` builds for its own configuration
    on the same data: the index, the membership words, the stream, its
    collision buffer, the eval set and the parameters, equal; the positive
    set is the other's."""
    users, items, values = _ratings()
    first = BPREngine(bpr_decomp.bpr_config(BATCH), device="cpu")
    first.init(Dataset(users, items, values))
    for _ in range(2):  # trained: init_like takes none of its state
        first._epoch()
    cfg = bpr_decomp.bpr_config(batch, bloom)
    want = BPREngine(cfg, device="cpu")
    want.init(Dataset(users, items, values))
    got = BPREngine(cfg, device="cpu")
    bpr_decomp.init_like(got, first)
    assert got._pos_set is first._pos_set
    np.testing.assert_array_equal(got.user_index.ids, want.user_index.ids)
    np.testing.assert_array_equal(got.item_index.ids, want.item_index.ids)
    member = "_pos_bloom" if bloom else "_pos_bitmap"
    assert getattr(got, member).words_per_user == getattr(
        want, member).words_per_user
    pairs = [(getattr(got, member).words, getattr(want, member).words),
             (got._grp_up, want._grp_up)]
    pairs += list(zip(got._eval_set, want._eval_set))
    pairs += list(zip(got.params, want.params))
    pairs += list(zip(got._pos_set, want._pos_set))[:2]
    assert all(torch.equal(a, b) for a, b in pairs)
    assert (got._grp_batch, got._collide_cap, got._n_real_pos,
            got._n_real_triplets) == (want._grp_batch, want._collide_cap,
                                      want._n_real_pos,
                                      want._n_real_triplets)
    assert list(got._init_stages) == ["pos_set"] + list(
        want._init_stages)[2:]
    with pytest.raises(RuntimeError, match="already initialized"):
        bpr_decomp.init_like(got, first)


@pytest.mark.parametrize("membership", ["word", "bloom"])
def test_decompose_parts(membership):
    """Every part finite and positive, the stages of the membership, and
    the counts of the run."""
    eng, _ = _engines(membership, dtype="float32")
    parts = bpr_decomp.decompose(eng, reps=1)
    assert parts["membership"] == membership
    assert parts["batch"] == BATCH and parts["nodes"] is None
    assert parts["real_triplets"] == N_POS * NUM_NEG
    assert list(parts["stages_ms"]) == list(bpr_decomp.stage_names(eng))
    ms = [v for k, v in parts.items() if k.endswith("_ms")
          and k != "stages_ms"]
    ms += list(parts["stages_ms"].values()) + list(
        parts["updates_per_s"].values())
    assert len(ms) == 9 + len(parts["stages_ms"]) + 2
    assert all(math.isfinite(x) and x > 0 for x in ms), parts
    # the parts timed in turns, a round each; the host step's parts sum to
    # the parted step
    for name in ("epoch", "pass1", "sgd", "parted_step", "host_epoch"):
        assert len(parts[f"{name}_ms_each"]) == 1
    assert parts["pass1_sgd_minus_epoch_ms_each"] == [
        parts["pass1_ms"] + parts["sgd_ms"] - parts["epoch_ms"]]
    assert math.isclose(parts["draws_ms"] + parts["launch_ms"]
                        + parts["wait_ms"], parts["parted_step_ms"])
    assert "pass 1 by stage" in bpr_decomp.report(parts)


def test_cpu_rehearsal_prints_finite_parts(capsys):
    assert bpr_decomp.main(["--device=cpu", "--preset=ml100k"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(last)
    assert got["device"] == "cpu" and got["card"] is None
    assert [r["batch"] for r in got["runs"]] == [32768, 8192]
    for run in got["runs"]:
        ms = [v for k, v in run.items() if k.endswith("_ms")
              and k != "stages_ms"]
        ms += list(run["stages_ms"].values())
        assert all(math.isfinite(x) and x > 0 for x in ms), run
        assert run["membership"] == "word"


def test_no_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bpr_decomp.main([]) != 0
    assert bpr_decomp.main(["--preset=ml100k", "--bloom"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


def test_no_card_exits_nonzero_as_a_program():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "qmf_tpu_torch.tools.bpr_decomp",
         "--preset=ml100k"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == "" and "no CUDA device" in proc.stderr
