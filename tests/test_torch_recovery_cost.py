"""tools/recovery_cost.py held against benchmarks/recovery_cost.py, and one
A/B pair of it on gloo CPU ranks.

The task files (ratings and task text) are the JAX probe's, apart from the
added ``solver`` line. One pair runs through the tool's ``main`` at a small
size in float64 (--device=cpu: the scheduler's and the labor's workers are
gloo CPU ranks, ``n_local_devices=1``), epochs stretched as
tests/test_torch_distributed.py's kill/retry case stretches them: run A
takes one attempt, run B two, the second resumed from the checkpoint, and
B's factor files equal A's within 1e-9; its printed lines parse with the
JAX probe's wording. Without a card, --device=cuda exits nonzero.
"""

import contextlib
import importlib
import io
import json
import os
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from qmf_tpu_torch.data import load_factors
from qmf_tpu_torch.tools import recovery_cost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the pair: ratings, epochs, k, epoch stretch (s); float64 factor files
NRATINGS, NEPOCHS, K, SLEEP_S = 3000, 4, 4, 0.75
F64_TOL = 1e-9
# the JAX probe's lines, in its wording
LINES = (
    r"uninterrupted: (?P<w0>[\d.]+)s wall, attempts=(?P<a0>\d+), "
    r"procs=(?P<p0>\d+)",
    r"killed-after-first-checkpoint: (?P<w1>[\d.]+)s wall \(kill at "
    r"\+(?P<kill>[\d.]+)s\), attempts=(?P<a1>\d+), procs=(?P<p1>\d+)",
    r"RECOVERY OVERHEAD: (?P<over>-?[\d.]+)s for one killed worker at "
    r"(?P<n>\d+) ratings x (?P<e>\d+) epochs, k=(?P<k>\d+), 2 processes "
    r"\(detection \+ abort \+ re-quorum \+ re-rendezvous \+ re-init \+ "
    r"resume from last epoch checkpoint\)",
)


@pytest.fixture(scope="module")
def probe():
    """benchmarks/recovery_cost.py, imported with argv and sys.path as they
    were (it reads argv[1:3] as integers and puts "." first)."""
    path = list(sys.path)
    sys.path.insert(0, REPO)
    try:
        with mock.patch.object(sys, "argv", ["recovery_cost.py"]):
            return importlib.import_module("benchmarks.recovery_cost")
    finally:
        sys.path[:] = path


@pytest.mark.parametrize("nratings,nepochs", [(NRATINGS, NEPOCHS),
                                              (200_000, 8)])
def test_task_files_are_the_jax_probes(probe, tmp_path, monkeypatch,
                                       nratings, nepochs):
    """The ratings file equals the JAX probe's byte for byte, and the task
    text equals its text plus ``solver : "auto"``."""
    monkeypatch.setattr(probe, "N_RATINGS", nratings)
    monkeypatch.setattr(probe, "NEPOCHS", nepochs)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    want = probe.make_task(str(jax_dir), "kill")
    got = recovery_cost.make_task(str(port_dir), "kill", nratings, nepochs)
    assert (port_dir / "train.txt").read_bytes() == \
        (jax_dir / "train.txt").read_bytes()
    with open(want) as f:
        want_text = f.read().replace(str(jax_dir), str(port_dir))
    with open(got) as f:
        assert f.read() == want_text + 'solver : "auto"\n'
    assert len((port_dir / "train.txt").read_text().splitlines()) == nratings


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """One A/B pair through main(): (stdout lines, JSON line, out dir)."""
    out_dir = tmp_path_factory.mktemp("recovery")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert recovery_cost.main([
            str(NRATINGS), str(NEPOCHS), f"--nfactors={K}",
            "--dtype=float64", f"--epoch_sleep_s={SLEEP_S}",
            f"--out_dir={out_dir}", "--device=cpu"]) == 0
    lines = out.getvalue().splitlines()
    return lines, json.loads(lines[-1]), out_dir


def test_pair_recovers_from_the_checkpoint(pair):
    """A takes one attempt and B two, of two processes each; B's resumed
    attempt ran some but not all epochs; the kill, the detection and the
    resumed epochs add up to B's wall; B's factors are A's."""
    _, res, out_dir = pair
    assert res["attempts"] == [1, 2]
    assert res["num_processes"] == [2, 2]
    assert 0 < res["resumed"]["epochs"] < NEPOCHS
    assert res["epoch_sleep_s"] == SLEEP_S
    assert res["t_kill_s"] + res["detect_s"] + res["resumed"]["wall_s"] \
        == pytest.approx(res["w1_s"], abs=2e-3)
    assert res["overhead_s"] == pytest.approx(res["w1_s"] - res["w0_s"],
                                              abs=2e-3)
    stages = res["resumed"]["stages"]
    assert res["resumed"]["startup_s"] + stages["save_s"] \
        + res["detect_other_s"] == pytest.approx(res["detect_s"], abs=2e-3)
    assert set(res["resumed"]["stages"]) >= {"import_s", "join_s", "read_s",
                                             "init_s", "save_s"}
    assert res["resumed"]["init_stages"]
    assert res["launches"] == [{"chol_solve": 0, "build_solve": 0,
                                "build_solve_hot": 0}] * 2
    assert res["device"] == "cpu" and res["card"] is None
    assert res["b_vs_a"]["max_abs"] <= F64_TOL
    for side in ("u", "i"):
        (ids_a, fa), (ids_b, fb) = (load_factors(str(out_dir / f"{side}_"
                                                     f"{run}0.dat"))
                                    for run in ("base", "kill"))
        np.testing.assert_array_equal(ids_a, ids_b)
        np.testing.assert_allclose(fb.factors, fa.factors, rtol=0,
                                   atol=F64_TOL)
    assert res["pairs"] == [{k: res[k] for k in res["pairs"][0]}]
    assert res["median"] == {k: res[k] for k in res["median"]}


def test_printed_lines_parse_with_the_jax_probes_wording(pair):
    lines, res, _ = pair
    got = [re.fullmatch(p, line) for p, line in zip(LINES, lines[-4:-1])]
    assert all(got), lines[-4:-1]
    a, b, over = (m.groupdict() for m in got)
    assert (float(a["w0"]), int(a["a0"]), int(a["p0"])) == (
        round(res["w0_s"], 1), 1, 2)
    assert (float(b["w1"]), float(b["kill"]), int(b["a1"]),
            int(b["p1"])) == (round(res["w1_s"], 1),
                              round(res["t_kill_s"], 1), 2, 2)
    assert (float(over["over"]), int(over["n"]), int(over["e"]),
            int(over["k"])) == (round(res["overhead_s"], 1), NRATINGS,
                                NEPOCHS, K)


def test_summary_takes_the_pair_of_median_overhead():
    pairs = [{"w0_s": w0, "w1_s": w1, "overhead_s": w1 - w0, "t_kill_s": 1.0,
              "detect_s": d, "detect_other_s": 0.5, "tag": t}
             for w0, w1, d, t in ((10.0, 19.0, 3.0, "a"),
                                  (11.0, 14.0, 2.0, "b"),
                                  (9.0, 20.0, 5.0, "c"),
                                  (10.0, 15.0, 4.0, "d"))]
    got = recovery_cost.summary(pairs)
    assert got["tag"] == "d"  # overheads 3, 5, 9, 11: the lower middle
    assert got["median"] == {"w0_s": 10.0, "w1_s": 17.0, "overhead_s": 7.0,
                             "t_kill_s": 1.0, "detect_s": 3.5,
                             "detect_other_s": 0.5}


def test_factor_diff_reads_files_that_differ(tmp_path):
    """Equal files differ by 0 unparsed; others by their max abs difference
    and its share of max(1, the row's max |A|); other ids raise."""
    files = {"a": "1 0.5 -4.0\n2 0.25 0.125\n",
             "b": "1 0.5 -3.0\n2 0.25 0.375\n",
             "c": "1 0.5 -4.0\n3 0.25 0.125\n"}
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    a, b, c = (str(tmp_path / n) for n in "abc")
    assert recovery_cost.factor_diff((a, a), (a, a)) == {"max_abs": 0.0,
                                                         "normwise": 0.0}
    assert recovery_cost.factor_diff((a, b), (a, a)) == {"max_abs": 1.0,
                                                         "normwise": 0.25}
    with pytest.raises(RuntimeError, match="ids differ"):
        recovery_cost.factor_diff((c,), (a,))


def test_without_a_card_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: --device=cuda would measure")
    proc = subprocess.run(
        [sys.executable, "-m", "qmf_tpu_torch.tools.recovery_cost", "100",
         "2", "--device=cuda"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr
