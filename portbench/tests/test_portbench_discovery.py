"""A configuration, a traffic mix, a cell and a per-layer metric added as new
files and entries are found without an edit of any file already there."""

import hashlib
import json
import os
import subprocess
import sys
import time

from portbench import harness, spec


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "portbench")):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[path] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tiny_root):
    before = _digests(tiny_root)
    pb = os.path.join(tiny_root, "portbench")
    with open(os.path.join(pb, "configs", "wals_ml20m_k64.json")) as f:
        cfg = json.load(f)
    cfg.update(name="wals_new_k16", settings=dict(cfg["settings"],
                                                  nfactors=16))
    with open(os.path.join(pb, "configs", "wals_new_k16.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "train_again.json"), "w") as f:
        json.dump({"driver": "{engine}_train", "loop": "closed",
                   "checked_calls": 3, "trace_calls": 1}, f)
    with open(os.path.join(pb, "limits", "wals_new_k16.train_again.json"),
              "w") as f:
        json.dump({"change1": 1e-4, "change3": 1e-4, "drift3": 1e-3,
                   "loss": 1e-4}, f)
    with open(os.path.join(pb, "metrics", "twice_init_s.py"), "w") as f:
        f.write("def read(ctx):\n    return 2 * ctx.init_s\n")
    bench_path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "wals_new_k16", "source": "a test", "reduced": [],
        "file": "portbench/configs/wals_new_k16.json", "why": "a test"})
    bench["workloads"].append({
        "name": "wals_new_k16.train_again", "config": "wals_new_k16",
        "traffic": "train_again", "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "wals_epoch_s")[
        "workloads"].append("wals_new_k16.train_again")
    bench["per_layer"].append({
        "name": "twice_init_s", "unit": "s", "better": "lower",
        "source": "host_clock", "layer": "set-up", "moves": "setup_s",
        "workloads": ["wals_new_k16.train_again"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    assert {p: d for p, d in _digests(tiny_root).items() if p in before} \
        == before

    # the copy's own harness, in a process of its own, finds them
    out = subprocess.run(
        [sys.executable, "-c",
         "import json; from portbench import spec; "
         "c = spec.resolve('wals_new_k16.train_again'); "
         "print(json.dumps([spec.__file__, c.driver, "
         "c.config['settings']['nfactors'], "
         "[m['name'] for m in c.end_to_end + c.per_layer]]))"],
        cwd=tiny_root, env={**os.environ, "PYTHONPATH": tiny_root},
        capture_output=True, text=True, check=True)
    where, driver, k, names = json.loads(out.stdout.splitlines()[-1])
    assert where.startswith(tiny_root)
    assert (driver, k) == ("wals_train", 16)
    assert {"setup_s", "wals_epoch_s", "twice_init_s"} <= set(names)

    cell = spec.resolve("wals_new_k16.train_again", root=tiny_root)
    r = harness.run_cell(cell, 99, 0.2, True, "cpu", time.perf_counter(),
                         root=tiny_root)
    assert r.correct, r.checks
    assert r.metrics["twice_init_s"]["value"] == \
        2 * r.metrics["init_s"]["value"]
