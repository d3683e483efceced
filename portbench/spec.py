"""Finds a cell's files by the names in ``BENCHMARK.json``.

- a configuration: the ``file`` its entry names (a JSON object);
- a traffic mix: ``portbench/traffic/<traffic>.json``, whose ``driver``
  names ``portbench/drivers/<driver>.py`` (``{engine}`` in it is the
  configuration's ``engine``);
- the operation and byte counts: ``portbench/counts/<driver>.py``;
- a metric: ``portbench/metrics/<name>.py``, whose ``read(ctx)`` returns
  the number or None;
- a cell's correctness limits: ``portbench/limits/<cell>.json``.

Adding any of them is adding files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``metric`` is read in ``cell``: its ``workloads`` name the
    cell, or it has none and the cell reports what it moves (an
    end-to-end metric without ``moves`` or ``workloads`` is everywhere)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: str
    end_to_end: list
    per_layer: list
    limits: dict = field(default_factory=dict)


def resolve(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files read."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(root, "portbench", "traffic",
                                 w["traffic"] + ".json"))
    driver = traffic["driver"].format(engine=config["engine"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    limits_path = os.path.join(root, "portbench", "limits", name + ".json")
    limits = _json(limits_path) if os.path.exists(limits_path) else {}
    return Cell(name, w["chips"], config, traffic, driver, e2e, per_layer,
                limits)


def driver_module(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.driver}")


def counts_module(cell: Cell):
    return importlib.import_module(f"portbench.counts.{cell.driver}")


def metric_reader(name: str, root: str = ROOT):
    """``read`` of ``portbench/metrics/<name>.py`` (a name may hold dots,
    so the file is loaded by its path)."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def peaks(kind: str, root: str = ROOT):
    """The published peaks of the device ``kind``, or None."""
    return _json(os.path.join(root, "portbench", "peaks.json")).get(kind)
