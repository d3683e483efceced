"""A copy of the benchmark's files at a size a CPU test can hold: every
configuration's data cut to 300 users x 200 items x 6,000 ratings and its
factors to 8, BPR's batch to 256, serving's requests to 64 users. The
limits, traffic and metrics are the committed ones; the CPU gets made-up
peaks, so that the shares read from the host's clock are read there too."""

from __future__ import annotations

import json
import os
import shutil

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
TINY_DATA = {"n_users": 300, "n_items": 200, "target_nnz": 6000,
             "min_degree": 5}


def tiny_copy(dest: str) -> str:
    shutil.copytree(PKG, os.path.join(dest, "portbench"),
                    ignore=shutil.ignore_patterns("tests", "_cache",
                                                  "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    configs = os.path.join(dest, "portbench", "configs")
    for name in os.listdir(configs):
        path = os.path.join(configs, name)
        with open(path) as f:
            cfg = json.load(f)
        cfg["data"] = dict(TINY_DATA)
        cfg["settings"]["nfactors"] = 8
        if "batch_size" in cfg["settings"]:
            cfg["settings"]["batch_size"] = 256
        with open(path, "w") as f:
            json.dump(cfg, f)
    path = os.path.join(dest, "portbench", "peaks.json")
    with open(path) as f:
        peaks = json.load(f)
    peaks["cpu"] = {"float32_flops_per_s": 1e12, "bytes_per_s": 1e11}
    with open(path, "w") as f:
        json.dump(peaks, f)
    path = os.path.join(dest, "portbench", "traffic", "serve.json")
    with open(path) as f:
        mix = json.load(f)
    mix.update(batch_users=64, trace_calls=3)
    with open(path, "w") as f:
        json.dump(mix, f)
    return dest


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    monkeypatch.setenv("QMF_TPU_LOGLEVEL", "WARNING")
    return tiny_copy(str(tmp_path))
