"""What a run and the reference load: no module whose top-level name is
jax, jaxlib, flax, qmf_tpu (the JAX package), benchmarks or bench,
compared whole; and the reference nothing of the program."""

import json
import os
import subprocess
import sys

from portbench import run

from conftest import ROOT

RUN_CELLS = """
import json, sys, time
from portbench import harness, run, spec
root = sys.argv[1]
for name in ("wals_ml20m_k64.train", "bpr_ml20m_k30.train",
             "wals_ml20m_k64.serve"):
    cell = spec.resolve(name, root=root)
    r = harness.run_cell(cell, 3, 1.0, False, "cpu", time.perf_counter(),
                         root=root)
    assert r.correct, r.checks
print(json.dumps([run.forbidden_modules(),
                  sorted({m.split('.')[0] for m in sys.modules})]))
"""

REFERENCE = """
import json, sys
import portbench.reference, portbench.reference.wals
import portbench.reference.bpr, portbench.reference.serve, portbench.compare
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def _top_names(code, *args):
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.splitlines()[-1])


def test_a_run_loads_nothing_forbidden(tiny_root):
    bad, names = _top_names(RUN_CELLS, tiny_root)
    assert bad == []
    assert "qmf_tpu_torch" in names  # the program ran
    assert not set(names) & run.FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = set(_top_names(REFERENCE))
    assert not names & (run.FORBIDDEN | {"qmf_tpu_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "qmf_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "benchmarks_x.y", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "bench", sys)
    assert run.forbidden_modules() == ["bench"]
