"""The port's measurement entry points, tools/bench.py and
tools/epoch_decomp.py, held against the root bench.py and qmf_tpu on the
CPU (ml100k from benchmarks.datagen, seed 42):

- the FLOP estimate equals the root bench's formula on qmf_tpu's engine,
  exactly, and the knobs keep the root bench's names and defaults;
- BPR's real triplet count and path equal qmf_tpu's at the bench's
  configuration;
- the spread guard takes the rounds, sleeps and round the root bench's
  takes on the same scripted epoch times;
- ``main(["--device=cpu"])`` rehearses both benchmarks and prints no
  metric line; without a card and without ``--device=cpu`` both tools exit
  nonzero;
- ``epoch_decomp.decompose`` returns every part, and its user-side build
  and solve equal qmf_tpu's ``_scan_class_build`` and ``_solve_dispatch``
  in float64 within 1e-9.
"""

import json
import math
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as root_bench
from benchmarks.datagen import PRESETS, generate
from qmf_tpu.config import BPRConfig as JaxBPRConfig
from qmf_tpu.config import WALSConfig as JaxWALSConfig
from qmf_tpu.data.dataset import Dataset as JaxDataset
from qmf_tpu.models.bpr import BPREngine as JaxBPREngine
from qmf_tpu.models.wals import WALSEngine as JaxWALSEngine
from qmf_tpu.ops import als_ops as jax_als
from qmf_tpu_torch import BPRConfig, WALSConfig
from qmf_tpu_torch.data import Dataset
from qmf_tpu_torch.models import BPREngine, WALSEngine
from qmf_tpu_torch.tools import bench, epoch_decomp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9


@pytest.fixture(scope="module")
def ml100k():
    return generate(**PRESETS["ml100k"], seed=42)


def _wals_cfg(k):
    """The root bench's WALSConfig (bench.py:271-290) at k."""
    return dict(nepochs=1, nfactors=k, regularization_lambda=0.05,
                confidence_weight=40.0, init_seed=0, batch_rows=8192,
                matmul_precision="default")


@pytest.mark.parametrize("k", [8, 64])
def test_flop_estimate_equals_root_bench(ml100k, k):
    """bench.py:323-331 on qmf_tpu's engine after init, and the port's
    estimate on its own engine: the same padded count and FLOPs."""
    cfg = _wals_cfg(k)
    jax_eng = JaxWALSEngine(JaxWALSConfig(**cfg))
    jax_eng.init(JaxDataset(*ml100k))
    padded = sum(b.size for bk in (jax_eng._user_buckets,
                                   jax_eng._item_buckets)
                 for b in bk.col_idx)
    n_rows = jax_eng.nusers + jax_eng.nitems
    want = 2 * padded * k * k + 2 * padded * k + n_rows * (
        k**3 / 3 + 2 * k * k
    )
    eng = WALSEngine(WALSConfig(**cfg), device="cpu")
    eng.init(Dataset(*ml100k))
    assert bench.epoch_flops(eng) == (want, padded)


def test_knobs_keep_the_root_bench_names_and_defaults(monkeypatch):
    """Every knob defaults to the root bench's value, and each is read
    from the root bench's variable."""
    knobs = bench.Knobs()
    for name, want in (("preset", "PRESET"), ("nfactors", "NFACTORS"),
                       ("epochs", "EPOCHS"),
                       ("spread_threshold", "SPREAD_THRESHOLD"),
                       ("spread_rounds", "SPREAD_ROUNDS"),
                       ("spread_sleep_s", "SPREAD_RETRY_SLEEP_S"),
                       ("precision", "PRECISION"),
                       ("baseline_reps", "BASELINE_REPS"),
                       ("bpr_nfactors", "BPR_NFACTORS"),
                       ("bpr_num_neg", "BPR_NUM_NEG"),
                       ("bpr_batch", "BPR_BATCH"),
                       ("width_grid", "WIDTH_GRID"),
                       ("skip_bpr", "SKIP_BPR")):
        assert getattr(knobs, name) == getattr(root_bench, want), name
    assert knobs.batch_rows == 8192
    env = {"QMF_BENCH_PRESET": "ml1m", "QMF_BENCH_NFACTORS": "16",
           "QMF_BENCH_SPREAD_SLEEP_S": "0.5", "QMF_BENCH_SKIP_BPR": "1",
           "QMF_BENCH_SOLVER": "fused", "QMF_BENCH_MAX_CLASSES": "4",
           "QMF_BENCH_BPR_ITEM_SCATTER": "dense"}
    got = bench.Knobs.from_env(env)
    assert (got.preset, got.nfactors, got.spread_sleep_s, got.skip_bpr,
            got.solver, got.max_classes, got.bpr_item_scatter) == (
        "ml1m", 16, 0.5, True, "fused", "4", "dense")
    assert bench.Knobs.from_env({}) == knobs


@pytest.mark.parametrize("num_neg", [3, 1])
def test_bpr_triplets_and_path_equal_qmf_tpu(ml100k, num_neg):
    """At the root bench's BPR configuration (bench.py:366-377)."""
    cfg = dict(nepochs=1, nfactors=30, num_negative_samples=num_neg,
               batch_size=32768, init_seed=0)
    jax_eng = JaxBPREngine(JaxBPRConfig(**cfg))
    jax_eng.init(JaxDataset(*ml100k))
    eng = BPREngine(BPRConfig(**cfg), device="cpu")
    eng.init(Dataset(*ml100k))
    assert int(eng._n_real_triplets) == int(jax_eng._n_real_triplets) > 0
    assert eng._grouped == jax_eng._grouped


class _ScriptedClock:
    """A clock that a step moves on by the next scripted epoch time."""

    def __init__(self, times):
        self.now, self.times, self.sleeps, self.steps = 1000.0, iter(times), \
            [], 0

    def time(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(s)

    def step(self):
        self.steps += 1
        self.now += next(self.times)


_QUIET = [0.2, 0.201, 0.199, 0.2005, 0.202]


def _noisy(drop, scale=1.0):
    """A round whose spread exceeds 15%, less ``drop`` off its slowest
    epoch, every time scaled by ``scale`` (the spread is not)."""
    return [t * scale for t in (0.2, 0.35, 0.21, 0.41 - drop, 0.22)]


GUARD_CASES = {
    "quiet": [_QUIET],
    "noisy_then_quiet": [_noisy(0.0), [t * 1.01 for t in _QUIET]],
    # spreads 82%, 95%, 73%, 86%: the third round is taken
    "all_noisy": [_noisy(d, 1 + 0.01 * r)
                  for r, d in enumerate((0.03, 0.0, 0.05, 0.02))],
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_spread_guard_equals_root_bench(case, monkeypatch):
    """The same scripted epoch times through bench._measure_steady (its
    clock and sleep patched) and the port's guard: the same median, rounds,
    sleeps and round taken."""
    rounds = GUARD_CASES[case]
    epochs, threshold, n_rounds, sleep_s = 5, 0.15, 4, 30.0
    flat = [t for r in rounds for t in r]
    theirs = _ScriptedClock(flat)
    monkeypatch.setattr(root_bench, "time", types.SimpleNamespace(
        time=theirs.time, sleep=theirs.sleep))
    for name, value in (("EPOCHS", epochs), ("SPREAD_THRESHOLD", threshold),
                        ("SPREAD_ROUNDS", n_rounds),
                        ("SPREAD_RETRY_SLEEP_S", sleep_s)):
        monkeypatch.setattr(root_bench, name, value)
    want = root_bench._measure_steady(theirs.step, "wals steady")
    ours = _ScriptedClock(flat)
    got = bench.measure_steady(ours.step, "wals steady", epochs, threshold,
                               n_rounds, sleep_s, clock=ours.time,
                               sleep=ours.sleep)
    assert got["median"] == want
    assert ours.steps == theirs.steps == got["rounds"] * epochs
    assert got["rounds"] == len(rounds)
    assert ours.sleeps == theirs.sleeps == [sleep_s] * (len(rounds) - 1)
    # each round's median is its own (the clock rounds at 1e-13 s)
    medians = [float(np.median(r)) for r in rounds]
    assert [i + 1 for i, m in enumerate(medians)
            if abs(m - want) < 1e-9] == [got["round"]]
    if case == "all_noisy":
        assert got["round"] == 3
    assert got["times"] == pytest.approx(rounds[got["round"] - 1], abs=1e-9)


def _metric_lines(out: str) -> list:
    lines = []
    for ln in out.splitlines():
        try:
            obj = json.loads(ln)
        except ValueError:
            continue
        if isinstance(obj, dict) and "metric" in obj:
            lines.append(obj)
    return lines


def test_cpu_rehearsal_runs_both_benchmarks(monkeypatch, capsys):
    """main(["--device=cpu"]) at ml100k: no metric line, one parseable
    rehearsal line, a finite WALS loss that does not rise, and BPR's
    grouped path with finite updates/s."""
    for name, value in (("PRESET", "ml100k"), ("NFACTORS", "8"),
                        ("EPOCHS", "3"), ("SPREAD_ROUNDS", "1"),
                        ("SPREAD_SLEEP_S", "0")):
        monkeypatch.setenv(f"QMF_BENCH_{name}", value)
    monkeypatch.delenv("REF", raising=False)
    assert bench.main(["--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert _metric_lines(out) == []
    rehearsal = [ln for ln in out.splitlines()
                 if ln.startswith("# cpu rehearsal: ")]
    assert len(rehearsal) == 1
    got = json.loads(rehearsal[0][len("# cpu rehearsal: "):])
    wals, bpr = got["wals"], got["bpr"]
    losses = wals["losses"]
    # the warm-up, 3 timed epochs and the profiled one
    assert len(losses) == 5 and all(map(math.isfinite, losses))
    assert all(b <= a for a, b in zip(losses, losses[1:])), losses
    assert wals["loss"] == losses[-2]
    assert len(wals["epochs_s"]) == 3 and wals["value"] > 0
    assert wals["vs_baseline"] is None and wals["solver"] == "cholesky"
    assert wals["hot_widths"] == {"user": 0, "item": 0}
    assert wals["profile"]["clock"] == "host"
    assert wals["profile"]["busy_share"] is None
    assert bpr["path"] == "grouped" and bpr["factors_finite"]
    assert math.isfinite(bpr["value"]) and bpr["value"] > 0


def test_no_card_exits_nonzero(monkeypatch, capsys):
    """Without a CUDA device and without --device=cpu both tools return
    nonzero and print no metric: no fall-back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) != 0
    assert bench.main(["--device=cuda"]) != 0
    assert epoch_decomp.main([]) != 0
    out, err = capsys.readouterr()
    assert _metric_lines(out) == [] and "no CUDA device" in err


def test_no_card_exits_nonzero_as_a_program():
    """``python -m qmf_tpu_torch.tools.bench`` with no card visible."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "qmf_tpu_torch.tools.bench"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == "" and "no CUDA device" in proc.stderr


@pytest.mark.parametrize("hot_width", [0, 32])
def test_decompose_matches_qmf_tpu(ml100k, hot_width):
    """A CPU float64 engine: every part of the decomposition, and its
    user-side (A, b) and solve against qmf_tpu's _scan_class_build and
    _solve_dispatch on the same factors, class by class, within 1e-9."""
    cfg = dict(nfactors=8, dtype="float64", hot_width=hot_width,
               init_seed=0)
    eng = WALSEngine(WALSConfig(**cfg), device="cpu")
    eng.init(Dataset(*ml100k))
    parts = epoch_decomp.decompose(eng, reps=1)
    build = "build_hot" if hot_width else "build"
    keys = ["epoch_ms", "remainder_ms"] + [
        f"{side}_{part}_ms" for side in ("user", "item")
        for part in (build, "solve") + (("build_cold",) if hot_width else ())]
    for key in keys:
        assert math.isfinite(parts[key]), key
        assert key == "remainder_ms" or parts[key] > 0, key
    assert parts["mode"] == "split" and parts["solver"] == "cholesky"
    assert parts["hot_widths"] == {"user": hot_width, "item": hot_width}
    assert "remainder" in epoch_decomp.report(parts)

    jax_eng = JaxWALSEngine(JaxWALSConfig(**cfg, solver="cholesky"))
    jax_eng.init(JaxDataset(*ml100k))
    y = jnp.asarray(eng.item_factors.numpy())
    yty = jax_als.gramian(y)
    if hot_width:
        hot_ids, hot_classes = jax_eng._user_hot
        y_hot, z = jax_als.hot_tables(y[hot_ids], eng.config.matmul_precision)
    else:
        hot_classes, y_hot, z = [None] * len(eng._user_classes), None, None
    systems = epoch_decomp.side_build(eng, "user")
    xs = epoch_decomp.side_solve(eng, systems)
    bk = jax_eng._user_buckets
    assert len(systems) == len(bk.col_idx) == len(xs)
    for i, ((a, b), x) in enumerate(zip(systems, xs)):
        np.testing.assert_array_equal(eng._user_classes[i][1].numpy(),
                                      np.asarray(bk.col_idx[i]))
        a_j, b_j, _ = jax_als._scan_class_build(
            y, yty, bk.col_idx[i], bk.values[i], bk.mask[i],
            eng.config.confidence_weight, eng.config.regularization_lambda,
            jax_eng._user_chunks[i], eng.config.matmul_precision,
            hot_classes[i], y_hot, z)
        x_j = jax_als._solve_dispatch(a_j, b_j, "cholesky")
        for got, want in ((a, a_j), (b, b_j), (x, x_j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hot_width", [0, 32])
def test_decompose_fused_parts(ml100k, hot_width):
    """Under solver "fused" build and solve are timed together a side,
    with and without the hot head, and the report says so."""
    eng = WALSEngine(WALSConfig(nfactors=8, solver="fused",
                                hot_width=hot_width,
                                matmul_precision="default"), device="cpu")
    eng.init(Dataset(*ml100k))
    parts = epoch_decomp.decompose(eng, reps=1)
    assert parts["mode"] == "fused"
    suffix = "_hot" if hot_width else ""
    for side in ("user", "item"):
        assert parts[f"{side}_build_solve{suffix}_ms"] > 0
        assert (f"{side}_build_solve_cold_ms" in parts) == bool(hot_width)
        assert f"{side}_solve_ms" not in parts
    assert "one kernel" in epoch_decomp.report(parts)
