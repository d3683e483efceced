"""The port's tracing hooks (qmf_tpu_torch/utils/tracing.py) on the CPU.

``trace`` is qmf_tpu's context manager on torch.profiler: a no-op without
a directory, else a Chrome trace written into the directory named by its
argument or by QMF_TPU_TRACE_DIR. ``annotate`` labels the engines' epochs
(``wals_epoch_{n}``, ``bpr_epoch_{n}``, at qmf_tpu's places), and the
trace holds each label around the epoch's operations.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from qmf_tpu_torch.config import BPRConfig, WALSConfig
from qmf_tpu_torch.data import Dataset
from qmf_tpu_torch.models import BPREngine, WALSEngine
from qmf_tpu_torch.utils import StepTimer, annotate, trace


def _dataset(seed=0, n_users=30, n_items=20, per_user=6):
    rng = np.random.default_rng(seed)
    users, items = [], []
    for u in range(n_users):
        users += [u + 1] * per_user
        items += list(rng.choice(n_items, size=per_user, replace=False) + 1)
    return Dataset(np.array(users), np.array(items),
                   rng.integers(1, 6, len(users)).astype(np.float64))


def _events(trace_dir):
    files = glob.glob(os.path.join(str(trace_dir), "*.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def _span(events, name):
    hits = [e for e in events if e.get("name") == name and e.get("ph") == "X"]
    assert len(hits) == 1, (name, len(hits))
    return hits[0]["ts"], hits[0]["ts"] + hits[0]["dur"]


def test_trace_without_a_directory_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.delenv("QMF_TPU_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with trace():
        x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0
    assert not torch.autograd.profiler._is_profiler_enabled
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("where", ["argument", "environment"])
def test_trace_around_a_wals_epoch(tmp_path, monkeypatch, where):
    """One CPU WALS epoch under trace(): the written trace holds the
    wals_epoch_1 span, and the solve's operations inside it."""
    eng = WALSEngine(WALSConfig(nepochs=1, nfactors=4, dtype="float64",
                                fuse_epoch=False), device="cpu")
    eng.init(_dataset())
    out = tmp_path / "trace"
    if where == "environment":
        monkeypatch.setenv("QMF_TPU_TRACE_DIR", str(out))
        ctx = trace()
    else:
        monkeypatch.delenv("QMF_TPU_TRACE_DIR", raising=False)
        ctx = trace(str(out))
    with ctx:
        eng.optimize()
    events = _events(out)
    lo, hi = _span(events, "wals_epoch_1")
    inside = {e["name"] for e in events
              if e.get("ph") == "X" and lo <= e["ts"] <= hi}
    assert any("cholesky" in name for name in inside), sorted(inside)
    assert not torch.autograd.profiler._is_profiler_enabled


def test_bpr_epochs_are_annotated(tmp_path):
    eng = BPREngine(BPRConfig(nepochs=2, nfactors=4, batch_size=32,
                              dtype="float64"), device="cpu")
    eng.init(_dataset(seed=1))
    with trace(str(tmp_path)):
        eng.optimize()
    events = _events(tmp_path)
    first, second = _span(events, "bpr_epoch_1"), _span(events, "bpr_epoch_2")
    assert first[1] <= second[0]


def test_annotate_nests_and_is_cheap_untraced(tmp_path):
    with annotate("outside"):  # no profiler: only the label's bookkeeping
        pass
    with trace(str(tmp_path)):
        with annotate("outer"):
            with annotate("inner"):
                torch.ones(4).sum()
    events = _events(tmp_path)
    outer, inner = _span(events, "outer"), _span(events, "inner")
    assert outer[0] <= inner[0] and inner[1] <= outer[1]


def test_step_timer_records_and_summarizes():
    timer = StepTimer()
    for _ in range(3):
        with timer.measure("epoch"):
            pass
    with pytest.raises(RuntimeError):
        with timer.measure("failing"):
            raise RuntimeError("recorded all the same")
    summary = timer.summary()
    assert summary["epoch"][0] == 3 and summary["failing"][0] == 1
    count, total, mean = summary["epoch"]
    assert mean == pytest.approx(total / count)
    timer.log_summary()
