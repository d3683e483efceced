"""tools/build_attrib.py held against qmf_tpu on the CPU (ml100k from the
port's tools.datagen, seed 42):

- each width class's split build (tools/epoch_decomp.py ``split_class``,
  what build_attrib times) equals qmf_tpu's ``_scan_class_build`` on the
  same factors, (A, b) in float64 within 1e-9, on both sides, at H = 0 and
  H = 32;
- each class's fused x (``fused_class``, build_solve's plain version here)
  equals the split build's class solved by the plain SPD solve, in float32
  within tests/test_torch_build_solve.py's fused-against-split tolerance
  (1e-4 of the largest entry);
- ``attribute`` gives every class and path finite and positive, with the
  operations it states; ``epoch_decomp.decompose`` keeps its keys after the
  refactor; ``main(["--device=cpu", ...])`` ends in a JSON line, and
  without a card the tool exits nonzero.
"""

import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qmf_tpu.config import WALSConfig as JaxWALSConfig
from qmf_tpu.data.dataset import Dataset as JaxDataset
from qmf_tpu.models.wals import WALSEngine as JaxWALSEngine
from qmf_tpu.ops import als_ops as jax_als
from qmf_tpu_torch import WALSConfig
from qmf_tpu_torch.data import Dataset
from qmf_tpu_torch.models import WALSEngine
from qmf_tpu_torch.ops import spd_solve
from qmf_tpu_torch.tools import build_attrib, epoch_decomp
from qmf_tpu_torch.tools.datagen import PRESETS, generate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9
K = 8


@pytest.fixture(scope="module")
def ml100k():
    return generate(**PRESETS["ml100k"], seed=42)


def _factors(eng, seed=3):
    """Both sides' factors made from a seed, in the engine's dtype: the
    item side then builds against nonzero user factors."""
    rng = np.random.default_rng(seed)
    eng.load_factors(
        torch.tensor(rng.normal(0, 0.3, (eng.nusers, K))),
        torch.tensor(rng.normal(0, 0.3, (eng.nitems, K))))


@pytest.mark.parametrize("hot_width", [0, 32])
def test_class_builds_match_qmf_tpu(ml100k, hot_width):
    """Class by class, both sides: the port's (A, b) against qmf_tpu's
    ``_scan_class_build`` with its own packing, chunks and hot state."""
    cfg = dict(nfactors=K, dtype="float64", hot_width=hot_width,
               init_seed=0)
    eng = WALSEngine(WALSConfig(**cfg), device="cpu")
    eng.init(Dataset(*ml100k))
    _factors(eng)
    jax_eng = JaxWALSEngine(JaxWALSConfig(**cfg, solver="cholesky"))
    jax_eng.init(JaxDataset(*ml100k))
    assert eng.hot_widths == {"user": hot_width, "item": hot_width}
    n_classes = 0
    for side in ("user", "item"):
        classes, _, _, y, n_fixed = epoch_decomp.side_state(eng, side)
        yj = jnp.asarray(y[:n_fixed].numpy())
        ytyj = jax_als.gramian(yj)
        bk = getattr(jax_eng, f"_{side}_buckets")
        chunks = getattr(jax_eng, f"_{side}_chunks")
        hot = getattr(jax_eng, f"_{side}_hot")
        if hot_width:
            hot_ids, hot_classes = hot
            y_hot, z = jax_als.hot_tables(yj[hot_ids],
                                          eng.config.matmul_precision)
        else:
            assert hot is None
            hot_classes, y_hot, z = [None] * len(classes), None, None
        setup = epoch_decomp.split_setup(eng, side)
        assert len(classes) == len(bk.col_idx) > 1
        for i in range(len(classes)):
            np.testing.assert_array_equal(classes[i][1].numpy(),
                                          np.asarray(bk.col_idx[i]))
            a, b = epoch_decomp.split_class(eng, side, i, setup)
            a_j, b_j, _ = jax_als._scan_class_build(
                yj, ytyj, bk.col_idx[i], bk.values[i], bk.mask[i],
                eng.config.confidence_weight,
                eng.config.regularization_lambda, chunks[i],
                eng.config.matmul_precision, hot_classes[i], y_hot, z)
            for got, want in ((a, a_j), (b, b_j)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=TOL, atol=TOL)
            n_classes += 1
    assert n_classes > 4


@pytest.mark.parametrize("hot_width", [0, 32])
def test_fused_class_equals_split_solve(ml100k, hot_width):
    """float32 at precision "default": each class's fused x (with the hot
    head where H > 0, and on the cold stream alone) against its split build
    solved by the plain SPD solve, with the same hot state."""
    eng = WALSEngine(WALSConfig(nfactors=K, hot_width=hot_width,
                                matmul_precision="default"), device="cpu")
    eng.init(Dataset(*ml100k))
    _factors(eng)
    for side in ("user", "item"):
        for hot in (True, False) if hot_width else (True,):
            split = epoch_decomp.split_setup(eng, side, hot)
            fused = epoch_decomp.fused_setup(eng, side, hot)
            for i in range(len(epoch_decomp.side_state(eng, side)[0])):
                a, b = epoch_decomp.split_class(eng, side, i, split)
                x_s = spd_solve.solve_spd_reference(a, b)
                x_f, loss = epoch_decomp.fused_class(eng, side, i, fused)
                assert x_f.dtype == torch.float32
                np.testing.assert_allclose(
                    x_f.numpy(), x_s.numpy(), rtol=0,
                    atol=1e-4 * float(x_s.abs().max()))
                assert bool(torch.isfinite(loss).all())


def test_attribute_parts(ml100k):
    """Every class of both sides on all four paths at H = 32, finite and
    positive; the operations are the stated ones; the sums are the sums."""
    eng = WALSEngine(WALSConfig(nfactors=K, hot_width=32,
                                matmul_precision="default"), device="cpu")
    eng.init(Dataset(*ml100k))
    got = build_attrib.attribute(eng, reps=1)
    assert got["hot_widths"] == {"user": 32, "item": 32} and got["k"] == K
    for side in ("user", "item"):
        rows = got["sides"][side]["classes"]
        assert len(rows) == len(epoch_decomp.side_state(eng, side)[0])
        for r in rows:
            n, d, h = r["N"], r["D"], r["H"]
            assert h == 32 and r["elements"] == n * d
            assert r["chunks"] == -(-n // r["chunk_b"])
            assert r["split_flops"] == 2 * n * d * K * K + 2 * n * h * (
                K * K + K) == r["fused_flops"]
            assert r["split_cold_flops"] == 2 * n * d * K * K
            for p in build_attrib.PATHS:
                for key in ("ms", "ns_per_element", "tflops"):
                    v = r[f"{p}_{key}"]
                    assert math.isfinite(v) and v > 0, (side, p, key)
        sums = got["sides"][side]["sums_ms"]
        assert list(sums) == list(build_attrib.PATHS)
        for p, ms in sums.items():
            assert ms == pytest.approx(sum(r[f"{p}_ms"] for r in rows))
    text = build_attrib.report(got)
    assert "sum of classes" in text and "split_cold" in text


def test_attribute_without_a_hot_head(ml100k):
    """At H = 0 the cold paths are absent, and the sums hold two paths."""
    eng = WALSEngine(WALSConfig(nfactors=K, hot_width=0,
                                matmul_precision="default"), device="cpu")
    eng.init(Dataset(*ml100k))
    assert build_attrib.h0_engine(eng, None, "cpu") is eng
    got = build_attrib.attribute(eng, reps=1)
    for side in ("user", "item"):
        assert list(got["sides"][side]["sums_ms"]) == ["split", "fused"]
        assert all("split_cold_ms" not in r
                   for r in got["sides"][side]["classes"])


@pytest.mark.parametrize("hot_width", [0, 32])
def test_decompose_keeps_its_keys(ml100k, hot_width):
    """epoch_decomp.decompose after the per-class refactor: the same keys
    as before it, for the split path."""
    eng = WALSEngine(WALSConfig(nfactors=K, hot_width=hot_width,
                                matmul_precision="default"), device="cpu")
    eng.init(Dataset(*ml100k))
    parts = epoch_decomp.decompose(eng, reps=1)
    sides = []
    for side in ("user", "item"):
        if hot_width:
            sides += [f"{side}_build_hot_ms", f"{side}_build_cold_ms"]
        else:
            sides += [f"{side}_build_ms"]
        sides.append(f"{side}_solve_ms")
    assert sorted(parts) == sorted(
        ["solver", "mode", "hot_widths", "rows", "epoch_ms",
         "epoch_ms_each", "remainder_ms"] + sides)


def test_cpu_rehearsal_ends_in_json(capsys):
    """main at ml100k with H = 32: both engines (32 and the H = 0 repack),
    each with its attribution and epoch_decomp's parts."""
    assert build_attrib.main(["--device=cpu", "--preset=ml100k",
                              "--hot_width=32"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(last)
    assert got["device"] == "cpu" and got["card"] is None
    widths = [r["attribution"]["hot_widths"] for r in got["runs"]]
    assert widths == [{"user": 32, "item": 32}, {"user": 0, "item": 0}]
    for run in got["runs"]:
        for side in run["attribution"]["sides"].values():
            assert all(math.isfinite(v) and v > 0
                       for v in side["sums_ms"].values())
        assert run["decomposition"]["epoch_ms"] > 0


def test_no_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert build_attrib.main([]) != 0
    assert build_attrib.main(["--preset=ml100k", "--hot_width=0"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


def test_no_card_exits_nonzero_as_a_program():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "qmf_tpu_torch.tools.build_attrib",
         "--preset=ml100k"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == "" and "no CUDA device" in proc.stderr
