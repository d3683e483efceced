"""On a card: one short run of each cell through the command, as a check
runs it. Skips without a CUDA card (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import spec

from conftest import ROOT

CELLS = [w["name"] for w in spec.load_benchmark(ROOT)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", name,
         "--seed", str(2**40 + 1), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode != 0 and out.stdout == ""
