"""BENCHMARK.json against the benchmark's contract, and every file it names
or that the harness finds by a name in it."""

import json
import os
import re

import pytest

from portbench import spec

from conftest import PKG, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark(ROOT)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_lines(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"])
                assert entry["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        group_names = [e["name"] for e in bench[group]]
        assert len(group_names) == len(set(group_names))
    metric_names = [m["name"] for m in bench["end_to_end"] +
                    bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_end_to_end_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_resolves_and_reports_enough(bench):
    for w in bench["workloads"]:
        cell = spec.resolve(w["name"], ROOT)
        assert w["chips"] == 1 == cell.chips
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert os.path.exists(os.path.join(PKG, "drivers",
                                           cell.driver + ".py"))
        assert os.path.exists(os.path.join(PKG, "counts",
                                           cell.driver + ".py"))
        assert cell.limits and all(
            isinstance(v, (int, float)) and v >= 0
            for v in cell.limits.values())
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(m["name"], ROOT))
            if "moves" in m:
                assert m["moves"] in names


def test_configs_files_and_reduced(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["control"] in ("tf32", "bfloat16")


def test_layers_of_per_layer_metrics(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    assert layers == {"set-up", "dispatch", "device", "kernels", "step"}
    for m in bench["per_layer"]:
        if m["name"].startswith(("roofline.", "mfu.")):
            assert m["unit"] == "%"
