"""The port's BPREngine and bpr CLI against qmf_tpu's, on the CPU.

The slice as a whole: both engines on one small dataset give equal indices,
streams and initial factors; then the port's engine, with its two draw
hooks replaying the JAX engine's PRNG key and the eval sets copied over,
ends three epochs in float64 within 1e-9 of qmf_tpu's factors and logged
losses (sequential scatter sums on both sides; the rest is the order of a
few additions per step). With its own generator the port passes qmf_tpu's
statistical tests, keeps eval negatives out of the positive sets, resumes
bit for bit, and its CLI writes files both packages read.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qmf_tpu.config import BPRConfig as JaxBPRConfig
from qmf_tpu.config import MetricsConfig as JaxMetricsConfig
from qmf_tpu.data import load_factors as jax_load_factors
from qmf_tpu.data.dataset import Dataset as JaxDataset
from qmf_tpu.metrics import MetricsEngine as JaxMetricsEngine
from qmf_tpu.models.bpr import BPREngine as JaxBPREngine
from qmf_tpu.ops import bpr_ops as jax_bpr
from qmf_tpu_torch import BPRConfig, MetricsConfig, convert
from qmf_tpu_torch.cli import bpr as port_cli
from qmf_tpu_torch.cli import recommend as recommend_cli
from qmf_tpu_torch.data import Dataset, load_factors
from qmf_tpu_torch.metrics import MetricsEngine
from qmf_tpu_torch.models import BPREngine
from qmf_tpu_torch.ops import bpr_ops as port_bpr


def _t(a):
    return torch.tensor(np.asarray(a))


def _keys(key, shape):
    return _t(jax.random.randint(key, shape, 0, 1 << 30, dtype=jnp.int32))


def _small_data(seed=0, n_users=25, n_items=30, n=400):
    """(train arrays, test arrays): a repeated pair and a value below 1.0
    in train; an unknown user, an unknown item and a low value in test."""
    rng = np.random.default_rng(seed)
    u = rng.integers(1, n_users + 1, n)
    i = rng.integers(101, 101 + n_items, n)
    v = np.ones(n)
    u[5], i[5] = u[4], i[4]  # a repeated pair
    v[7] = 0.5
    tu = np.concatenate([rng.integers(1, n_users + 1, 60), [999, u[0]]])
    ti = np.concatenate([rng.integers(101, 101 + n_items, 60), [i[0], 9999]])
    tv = np.ones(62)
    tv[3] = 0.5
    return (u, i, v), (tu, ti, tv)


class ReplayEngine(BPREngine):
    """The port's engine drawing what qmf_tpu's draws: its two draw hooks
    split a JAX key as JaxBPREngine._epoch and the epoch functions do."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._jax_key = jax.random.PRNGKey(self.config.init_seed)

    def _epoch_key(self):
        self._jax_key, sub = jax.random.split(self._jax_key)
        return sub

    def _draw_grouped_keys(self):
        # sgd_epoch_grouped, then _sample_pack_grouped_body
        _, skey = jax.random.split(self._epoch_key())
        key2, rkey = jax.random.split(skey)
        rk = _keys(rkey, (self.config.neg_resample_rounds, 3))
        if not self.config.shuffle_training_set:
            return rk, None
        _, mkey = jax.random.split(key2)
        return rk, _keys(mkey, (6,))

    def _draw_legacy(self):
        # sgd_epoch's packed path, then _sample_pack_impl
        assert self._legacy_packed()
        _, skey = jax.random.split(self._epoch_key())
        ks = None
        if self.config.shuffle_training_set:
            skey, mkey = jax.random.split(skey)
            ks = _keys(mkey, (3,))
        _, sub = jax.random.split(skey)
        n = self._tri_users.shape[0]
        return ks, _t(jax.random.randint(
            sub, (self.config.neg_resample_rounds, n), 0, self.nitems,
            dtype=jnp.int32))


def _assert_same_init(pe, je):
    np.testing.assert_array_equal(pe.user_index.ids, je.user_index.ids)
    np.testing.assert_array_equal(pe.item_index.ids, je.item_index.ids)
    assert pe._grouped == je._grouped
    assert pe._n_real_triplets == je._n_real_triplets
    if pe._grouped:
        assert pe._collide_cap == je._collide_cap
        assert pe._grp_batch == je._grp_batch
        assert pe._grp_up.dtype == torch.int32
        np.testing.assert_array_equal(pe._grp_up.numpy(),
                                      np.asarray(je._grp_up))
    else:
        for name in ("_tri_users", "_tri_items", "_tri_weights"):
            got, want = getattr(pe, name).numpy(), np.asarray(getattr(je, name))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for got, want in zip(pe.params, je.params):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for name in ("_pos_bitmap", "_pos_bloom"):
        got, want = getattr(pe, name), getattr(je, name)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got.words.numpy(),
                                          np.asarray(want.words))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(grouped_epoch=False),
    dict(use_biases=True, neg_sampler="rounds", item_scatter="merged"),
    dict(bitmap_budget_mb=0, item_scatter="dense", shuffle_training_set=False),
    dict(item_scatter="dense", decay_rate=0.9),
], ids=["grouped", "legacy", "biases-rounds-merged", "bloom-dense-noshuffle",
        "dense-decay"])
def test_engine_replays_qmf_tpu(kw):
    """Both engines, same data, same draws, 3 epochs in float64 with the
    learning-rate decay: factors and logged losses within 1e-9."""
    train, test = _small_data()
    cfg = dict(nepochs=3, nfactors=6, batch_size=32, dtype="float64",
               init_seed=4, init_learning_rate=0.08, **kw)
    je = JaxBPREngine(JaxBPRConfig(**cfg))
    je.init(JaxDataset(*train))
    je.init_test(JaxDataset(*test))
    pe = ReplayEngine(BPRConfig(**cfg), device="cpu")
    pe.init(Dataset(*train))
    pe.init_test(Dataset(*test))
    _assert_same_init(pe, je)
    assert pe._grouped == kw.get("grouped_epoch", True)
    # test rows with an unknown id or a low value are dropped by both
    assert pe._test_eval_set[0].shape[0] == je._test_eval_set[0].shape[0] \
        == 59 * 3
    # the eval sets are drawn by each package's own RNG: copy qmf_tpu's
    pe._eval_set = tuple(_t(x) for x in je._eval_set)
    pe._test_eval_set = tuple(_t(x) for x in je._test_eval_set)

    want_losses, got_losses = [], []
    jax_evaluate = je.evaluate

    def evaluate(epoch, elapsed=0.0):
        want_losses.append(tuple(
            float(jax_bpr.eval_loss(je.params, *s,
                                    use_biases=je.config.use_biases))
            for s in (je._eval_set, je._test_eval_set)))
        jax_evaluate(epoch, elapsed)

    je.evaluate = evaluate
    pe.progress_cb = lambda e, tr, te, dt: got_losses.append((tr, te))
    je.optimize()
    pe.optimize()
    assert pe.learning_rate == pytest.approx(je.learning_rate, abs=1e-15)
    assert pe.learning_rate < 0.08
    for got, want in zip(pe.params, je.params):
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-9
    assert np.abs(np.array(got_losses) - np.array(want_losses)).max() <= 1e-9
    assert len(got_losses) == 3 and got_losses[-1] != got_losses[0]


def test_bpr_params_from_jax_round_trip():
    train, _ = _small_data()
    je = JaxBPREngine(JaxBPRConfig(nfactors=4, use_biases=True))
    je.init(JaxDataset(*train))
    p = convert.bpr_params_from_jax(
        *(np.asarray(a) for a in je.params), torch.float32, "cpu")
    assert isinstance(p, port_bpr.BPRParams)
    for got, want in zip(p, je.params):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    z = convert.bpr_params_from_jax(
        np.asarray(je.params.user_factors), np.asarray(je.params.item_factors),
        None, torch.float64, "cpu")
    assert z.item_biases.dtype == torch.float64 and not z.item_biases.any()
    with pytest.raises(ValueError, match="item biases"):
        convert.bpr_params_from_jax(np.zeros((2, 3)), np.zeros((4, 3)),
                                    np.zeros(5), torch.float32, "cpu")


# --- with the port's own generator ---------------------------------------------

def _two_groups(rng, n_users=30, n_items=24, per_user=8):
    users, items = [], []
    for u in range(n_users):
        liked = range(0, n_items // 2) if u % 2 == 0 else \
            range(n_items // 2, n_items)
        for i in rng.choice(list(liked), size=per_user, replace=False):
            users.append(u + 1)
            items.append(i + 1)
    return np.array(users), np.array(items), np.ones(len(users))


def _pos_sets(users, items):
    sets = {}
    for u, i in zip(users, items):
        sets.setdefault(int(u), set()).add(int(i))
    return sets


def test_learns_pairwise_preferences():
    """tests/test_bpr.py's statistical test for the port: after training,
    most (user, positive, unobserved) pairs score the positive higher."""
    ds = Dataset(*_two_groups(np.random.default_rng(42), n_items=24))
    correct, total = 0, 0
    for trial in range(3):
        cfg = BPRConfig(
            nepochs=30, nfactors=8, init_learning_rate=0.1, decay_rate=0.95,
            num_negative_samples=3, batch_size=256, init_seed=trial)
        engine = BPREngine(cfg, device="cpu")
        engine.init(ds)
        engine.optimize()
        scores = (engine.params.user_factors
                  @ engine.params.item_factors.T).numpy()
        pos_sets = _pos_sets(engine._data_users, engine._data_items)
        check_rng = np.random.default_rng(trial)
        for _ in range(300):
            u = int(check_rng.integers(engine.nusers))
            pos_list = sorted(pos_sets[u])
            p = pos_list[check_rng.integers(len(pos_list))]
            n = int(check_rng.integers(engine.nitems))
            while n in pos_sets[u]:
                n = int(check_rng.integers(engine.nitems))
            total += 1
            correct += bool(scores[u, p] > scores[u, n])
    assert correct / total > 0.9, f"only {correct}/{total} correct"


def test_eval_loss_decreases():
    rng = np.random.default_rng(1)
    ds = Dataset(rng.integers(1, 20, 300), rng.integers(1, 15, 300),
                 np.ones(300))
    global_rng = torch.get_rng_state()
    engine = BPREngine(BPRConfig(nepochs=1, nfactors=4, batch_size=128,
                                 init_learning_rate=0.05), device="cpu")
    engine.init(ds)
    l0 = float(port_bpr.eval_loss(engine.params, *engine._eval_set,
                                  use_biases=False))
    for _ in range(10):
        engine._epoch()
    l1 = float(port_bpr.eval_loss(engine.params, *engine._eval_set,
                                  use_biases=False))
    assert l1 < l0
    # init and the epochs drew from the engine's generators only
    assert torch.equal(global_rng, torch.get_rng_state())


@pytest.mark.parametrize("budget", [4096, 0], ids=["bitmap", "csr"])
def test_eval_negatives_are_never_positives(budget, monkeypatch):
    """Train eval negatives avoid the user's train positives, test eval
    negatives the user's TEST positives; sampled in chunks, still so."""
    from qmf_tpu_torch.models import bpr as port_model

    monkeypatch.setattr(port_model, "_EVAL_SAMPLE_CHUNK", 100)
    train, test = _small_data(3)
    engine = BPREngine(BPRConfig(nfactors=4, bitmap_budget_mb=budget),
                       eval_num_neg=2, device="cpu")
    engine.init(Dataset(*train))
    engine.init_test(Dataset(*test))
    keep = train[2] >= 1.0
    n_pos = int(keep.sum())
    ev_u, ev_p, ev_n = (x.numpy() for x in engine._eval_set)
    assert ev_u.dtype == ev_n.dtype == np.int32 and len(ev_n) == n_pos * 2
    pos_sets = _pos_sets(engine._data_users, engine._data_items)
    for u, p, n in zip(ev_u, ev_p, ev_n):
        assert int(p) in pos_sets[int(u)] and int(n) not in pos_sets[int(u)]
        assert 0 <= n < engine.nitems
    tu, tp, tn = (x.numpy() for x in engine._test_eval_set)
    test_sets = _pos_sets(tu, tp)
    assert len(tn) == 59 * 2
    for u, n in zip(tu, tn):
        assert int(n) not in test_sets[int(u)]
    # seeded: a second engine draws the same eval sets
    again = BPREngine(BPRConfig(nfactors=4, bitmap_budget_mb=budget),
                      eval_num_neg=2, device="cpu")
    again.init(Dataset(*train))
    assert torch.equal(again._eval_set[2], engine._eval_set[2])


def test_init_test_with_no_known_rows():
    engine = BPREngine(BPRConfig(nfactors=4), device="cpu")
    engine.init(Dataset(*_small_data()[0]))
    engine.init_test(Dataset(np.array([999]), np.array([9999]), np.ones(1)))
    assert engine._test_eval_set[2].shape == (0,)
    engine.evaluate(1)  # logs -1 for the test loss, does not raise
    with pytest.raises(RuntimeError, match="already initialized with test"):
        engine.init_test(Dataset(*_small_data()[1]))
    with pytest.raises(RuntimeError, match="already initialized with train"):
        engine.init(Dataset(*_small_data()[0]))


def test_divergence_guard():
    rng = np.random.default_rng(2)
    ds = Dataset(rng.integers(1, 10, 100), rng.integers(1, 10, 100),
                 np.ones(100))
    engine = BPREngine(BPRConfig(nepochs=40, nfactors=4,
                                 init_learning_rate=1e6, decay_rate=1.0,
                                 batch_size=64), device="cpu")
    engine.init(ds)
    with pytest.raises(FloatingPointError, match="init_learning_rate"):
        engine.optimize()
    with pytest.raises(RuntimeError, match="initialized the engine"):
        BPREngine(BPRConfig(), device="cpu").optimize()


@pytest.mark.parametrize("kw", [dict(), dict(grouped_epoch=False),
                                dict(batch_size=48)],
                         ids=["grouped", "packed", "in-step"])
def test_checkpoint_resume_equals_straight_run(tmp_path, kw):
    """A run cut after 3 of 6 epochs and resumed ends bit for bit where a
    straight run ends: the checkpoint carries the generator's state."""
    ds = Dataset(*_two_groups(np.random.default_rng(21)))

    def run(ckpt=None, stop_after=None):
        cfg = BPRConfig(**{**dict(nepochs=6, nfactors=4, batch_size=64,
                                  init_seed=5, use_biases=True), **kw})
        e = BPREngine(cfg, device="cpu")
        e.init(ds)
        if ckpt:
            e.enable_checkpointing(str(ckpt))
        if stop_after is not None:
            orig, count = e._epoch, {"n": 0}

            def counted():
                if count["n"] >= stop_after:
                    raise KeyboardInterrupt
                count["n"] += 1
                orig()

            e._epoch = counted
            with pytest.raises(KeyboardInterrupt):
                e.optimize()
        else:
            e.optimize()
        return e

    straight = run()
    run(ckpt=tmp_path / "ck", stop_after=3)
    resumed = run(ckpt=tmp_path / "ck")
    assert resumed.learning_rate == straight.learning_rate
    for a, b in zip(straight.params, resumed.params):
        assert torch.equal(a, b)
    # and another seed does not give these factors
    other = BPREngine(BPRConfig(**{**dict(nepochs=6, nfactors=4,
                                          batch_size=64, init_seed=5,
                                          use_biases=True), **kw}),
                      device="cpu")
    other.init(ds)
    other._generator.manual_seed(6)
    other.optimize()
    assert not torch.equal(other.params.user_factors,
                           straight.params.user_factors)


def test_resumes_factors_of_a_qmf_tpu_checkpoint(tmp_path):
    """The factor arrays of a checkpoint pass between the packages; the
    JAX key under step_key is no generator state and is left aside."""
    train, _ = _small_data()
    cfg = dict(nepochs=2, nfactors=4, batch_size=32, use_biases=True)
    je = JaxBPREngine(JaxBPRConfig(**cfg))
    je.init(JaxDataset(*train))
    je.enable_checkpointing(str(tmp_path))
    je.optimize()
    pe = BPREngine(BPRConfig(**{**cfg, "nepochs": 2}), device="cpu")
    pe.init(Dataset(*train))
    state = pe._generator.get_state().clone()
    pe.enable_checkpointing(str(tmp_path))
    pe.optimize()  # epoch 2 is done: resumes and runs nothing
    for got, want in zip(pe.params, je.params):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pe.learning_rate == pytest.approx(je.learning_rate)
    assert torch.equal(pe._generator.get_state(), state)


def test_reject_reasons_and_fallbacks(caplog):
    """The engine trains what qmf_tpu trains: a batch that is no power of
    two, too many rounds or negatives fall back to the triplet stream, with
    qmf_tpu's reason in the log."""
    import logging

    ds = Dataset(*_two_groups(np.random.default_rng(0)))
    cases = [
        (dict(batch_size=48), "batch_size=48 is not a power of two"),
        (dict(neg_resample_rounds=8), "neg_resample_rounds=8 outside [1, 4]"),
        (dict(num_negative_samples=16), "leaves no user bits"),
        (dict(grouped_epoch=False), "disabled by config"),
    ]
    logger = logging.getLogger("qmf_tpu_torch")
    logger.addHandler(caplog.handler)
    caplog.set_level(logging.INFO, logger="qmf_tpu_torch")
    try:
        for kw, reason in cases:
            caplog.clear()
            cfg = {**dict(nepochs=1, nfactors=4, batch_size=64), **kw}
            pe = BPREngine(BPRConfig(**cfg), device="cpu")
            pe.init(ds)
            je = JaxBPREngine(JaxBPRConfig(**cfg))
            je.init(JaxDataset(ds.user_ids, ds.item_ids, ds.values))
            assert not pe._grouped and not je._grouped
            assert reason in caplog.text
            _assert_same_init(pe, je)
            pe.optimize()
            assert all(torch.isfinite(t).all() for t in pe.params)
    finally:
        logger.removeHandler(caplog.handler)
    grouped = BPREngine(BPRConfig(nfactors=4, batch_size=64), device="cpu")
    grouped.init(ds)
    assert grouped._grouped


def test_bad_choices_raise_value_errors():
    with pytest.raises(ValueError, match="unknown BPR neg_sampler 'Word'"):
        BPRConfig(neg_sampler="Word")
    with pytest.raises(ValueError, match="unknown BPR item_scatter 'Dense'"):
        BPRConfig(item_scatter="Dense")
    # qmf_tpu raises the same words when its engine starts
    je = JaxBPREngine(JaxBPRConfig(nfactors=4, item_scatter="Dense"))
    with pytest.raises(ValueError, match="unknown BPR item_scatter 'Dense'"):
        je.init(JaxDataset(*_small_data()[0]))
    # every field and default of qmf_tpu's config
    import dataclasses

    want = {f.name: f.default for f in dataclasses.fields(JaxBPRConfig)}
    got = {f.name: f.default for f in dataclasses.fields(BPRConfig)}
    assert got == want
    BPRConfig(unroll_membership=True)  # accepted


def test_overflow_is_logged_at_evaluate(caplog):
    """A collision buffer too small for the colliders: the count stays on
    the device through the epoch and evaluate logs it."""
    import logging

    rng = np.random.default_rng(0)
    # 4 users x 12 of 16 items positive: ~3/4 of the candidates collide
    u = np.repeat(np.arange(1, 5), 12)
    i = np.concatenate([rng.choice(16, 12, replace=False) for _ in range(4)])
    engine = BPREngine(BPRConfig(nepochs=1, nfactors=4, batch_size=16,
                                 neg_sampler="rounds"), device="cpu")
    engine.init(Dataset(u, i + 1, np.ones(48)))
    engine._collide_cap = 8
    logger = logging.getLogger("qmf_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        engine._epoch()
        assert isinstance(engine._last_overflow, torch.Tensor)
        engine.evaluate(1)
    finally:
        logger.removeHandler(caplog.handler)
    assert "collision buffer overflowed by" in caplog.text
    assert engine._last_overflow is None and engine.overflow_slots > 0


# --- the CLI -----------------------------------------------------------------------

def _write(path, users, items, values):
    with open(path, "w") as f:
        for u, i, v in zip(users, items, values):
            f.write(f"{u} {i} {v:.1f}\n")


@pytest.mark.parametrize("use_biases", [False, True])
def test_cli_writes_files_both_packages_read(tmp_path, use_biases):
    train, test = _small_data(5)
    paths = {n: str(tmp_path / n) for n in
             ("train.txt", "test.txt", "user.dat", "item.dat", "recs.txt")}
    _write(paths["train.txt"], *train)
    _write(paths["test.txt"], *test)
    rc = port_cli.main([
        f"--train_dataset={paths['train.txt']}",
        f"--test_dataset={paths['test.txt']}", "--test_avg_metrics=auc",
        f"--user_factors={paths['user.dat']}",
        f"--item_factors={paths['item.dat']}", "--nepochs=3", "--nfactors=5",
        "--batch_size=64", "--device=cpu",
    ] + (["--use_biases"] if use_biases else []))
    assert rc == 0
    n_cols = 1 + 5 + int(use_biases)
    with open(paths["item.dat"]) as f:
        assert all(len(ln.split()) == n_cols for ln in f)
    for load in (load_factors, jax_load_factors):
        uids, ufd = load(paths["user.dat"])
        iids, ifd = load(paths["item.dat"], with_biases=use_biases)
        assert ufd.factors.shape == (len(uids), 5)
        assert ifd.factors.shape == (len(iids), 5)
        assert np.isfinite(ifd.factors).all()
        if use_biases:
            assert ifd.biases.shape == (len(iids),) and ifd.biases.any()
    keep = train[2] >= 1.0
    assert sorted(uids) == sorted(set(train[0][keep]))
    # the recommend CLI serves from them
    rc = recommend_cli.main([
        f"--user_factors={paths['user.dat']}",
        f"--item_factors={paths['item.dat']}", f"--output={paths['recs.txt']}",
        "--topn=3", "--device=cpu",
    ] + (["--item_biases"] if use_biases else []))
    assert rc == 0
    with open(paths["recs.txt"]) as f:
        lines = f.read().splitlines()
    assert len(lines) == len(uids)
    assert all(len(ln.split("\t")[1].split()) == 3 for ln in lines)


def test_cli_refuses_more_than_one_device(tmp_path):
    """More devices than there are cards, and --n_devices=0 on the CPU,
    which has no device count, are refused before any rank starts; N CPU
    ranks run (tests/test_torch_parallel.py)."""
    with pytest.raises(ValueError, match="requested 999 devices"):
        port_cli.main(["--n_devices=999", "--device=cuda"])
    with pytest.raises(ValueError, match="--n_devices=0"):
        port_cli.main(["--n_devices=0", "--device=cpu"])


def test_cli_flags_are_qmf_tpus_plus_device():
    from qmf_tpu.cli import bpr as jax_cli

    def flags(module):
        fl = module.make_flags()
        fl.parse([])
        return {name: getattr(fl, name) for name in (
            "nepochs", "nfactors", "init_learning_rate", "bias_lambda",
            "user_lambda", "item_lambda", "decay_rate", "use_biases",
            "init_distribution_bound", "num_negative_samples",
            "num_hogwild_threads", "shuffle_training_set", "eval_num_neg",
            "eval_seed", "nthreads", "train_dataset", "test_dataset",
            "test_avg_metrics", "num_test_users", "test_always",
            "user_factors", "item_factors", "dtype", "batch_size",
            "neg_resample_rounds", "init_seed", "neg_sampler", "n_devices",
            "item_scatter")}

    assert flags(port_cli) == flags(jax_cli)
    fl = port_cli.make_flags()
    fl.parse(["--device=cpu"])
    assert fl.device == "cpu"
    fl = port_cli.make_flags()
    fl.parse([])
    assert fl.device == "cuda"  # the card unless the caller asks for the CPU


def test_engine_runs_on_the_card_unless_asked():
    """No quiet fallback: the default device is cuda, and without a card the
    engine fails where it first touches it."""
    import inspect

    assert inspect.signature(BPREngine).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            BPREngine(BPRConfig())


# --- both packages, their own random numbers -----------------------------------------

def test_auc_matches_qmf_tpu_on_two_clusters():
    """Two-cluster data (even users like the first half of the items, odd
    users the second), 8 train and 4 test items a user; each package trains
    with its own random numbers. Test AUC of the port within 0.01 of
    qmf_tpu's. The tolerance is this wide because 60 users x 4 test items
    against 46 other items is ~11,000 pairs in all, and each run's AUC
    moves by a few 1e-3 with the seed at this size. The 8 train items of a
    user count as unrated and score high, which holds the AUC near 0.75."""
    rng = np.random.default_rng(7)
    n_users = 60  # x 50 items
    tr, te = [], []
    for u in range(n_users):
        liked = np.arange(0, 25) if u % 2 == 0 else np.arange(25, 50)
        picks = rng.choice(liked, size=12, replace=False)
        tr += [(u + 1, i + 1) for i in picks[:8]]
        te += [(u + 1, i + 1) for i in picks[8:]]
    tr, te = np.array(tr), np.array(te)
    cfg = dict(nepochs=40, nfactors=8, init_learning_rate=0.1,
               batch_size=128, init_seed=1)
    aucs = []
    for config_cls, mcfg_cls, me_cls, ds_cls, engine_cls, kw in (
        (JaxBPRConfig, JaxMetricsConfig, JaxMetricsEngine, JaxDataset,
         JaxBPREngine, {}),
        (BPRConfig, MetricsConfig, MetricsEngine, Dataset, BPREngine,
         {"device": "cpu"}),
    ):
        me = me_cls(mcfg_cls())
        assert me.add_test_avg_metric("auc")
        engine = engine_cls(config_cls(**cfg), me, **kw)
        engine.init(ds_cls(tr[:, 0], tr[:, 1], np.ones(len(tr))))
        engine.init_test(ds_cls(te[:, 0], te[:, 1], np.ones(len(te))))
        engine.optimize()
        aucs.append(me.last("test_avg_auc")[1])
    assert aucs[0] > 0.7 and aucs[1] > 0.7, aucs
    assert abs(aucs[0] - aucs[1]) <= 0.01, aucs
