"""One run of one cell: set-up, the measured (or traced) window, the check.

A driver (``portbench/drivers/<name>.py``) has ``Driver(config, traffic,
seed, device)`` with

- ``setup() -> {"init_s", "warmup_s"}``: data, the program's set-up and the
  first calls of the entry the window drives (the calls the check follows);
- ``call() -> (units, work)``: one call of that entry, waited for; ``units``
  in the end-to-end metric's unit (epochs, updates, users), ``work`` in the
  counts' unit (``portbench/counts/<name>.py`` ``per_work``);
- ``stats``: what the counts read (sizes of the data and the
  configuration), known after ``setup``;
- ``release()``: frees the program's state, keeping what the check reads;
- ``check(**fault) -> {name: value}``: the numbers that the cell's limits
  (``portbench/limits/<cell>.json``) name are compared, each at most its
  limit (``verdict``); a number without a limit is not compared. With
  ``precision=`` the reference in that precision takes the program's
  place (the control); ``FAULTS``, a class attribute, maps the name of
  each fault the reference can plant in the program's place to the
  keyword arguments of ``check`` that plant it.

The traced run (``--trace 1``) times ``trace_calls`` calls on the host's
clock first (the whole step's wall, which the profiler would stretch), then
traces a lead-in call and ``trace_calls`` more (``portbench/trace.py``).
"""

from __future__ import annotations

import gc
import statistics
import time
from dataclasses import dataclass, field

import torch

from portbench import spec, trace


@dataclass
class Context:
    """What a metric reader (``portbench/metrics/<name>.py``) reads."""

    setup_s: float
    init_s: float
    warmup_s: float
    window_s: float = 0.0
    calls: int = 0
    units: float = 0.0
    work: float = 0.0
    untraced_s: float = 0.0  # the traced run's host-timed calls
    untraced_work: float = 0.0
    latencies_s: list = field(default_factory=list)
    flops_per_work: float = 0.0
    bytes_per_work: float = 0.0
    peaks: dict | None = None
    trace: trace.TraceSummary | None = None


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: dict
    breakdown: dict | None = None


def _sync(device: torch.device):
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return sync


def device_info(device: torch.device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float, root: str = spec.ROOT) -> Result:
    device = torch.device(device)
    sync = _sync(device)
    drv = spec.driver_module(cell).Driver(cell.config, cell.traffic, seed,
                                         device)
    times = drv.setup()
    sync()
    ctx = Context(setup_s=time.perf_counter() - t_start, **times)
    flops, nbytes = spec.counts_module(cell).per_work(cell.config,
                                                      cell.traffic, drv.stats)
    ctx.flops_per_work, ctx.bytes_per_work = flops, nbytes
    kind = device_info(device, cell.chips)["kind"]
    ctx.peaks = spec.peaks(kind, root)
    if traced:
        n = cell.traffic["trace_calls"]
        t0 = time.perf_counter()
        ctx.untraced_work = sum(drv.call()[1] for _ in range(n))
        ctx.untraced_s = time.perf_counter() - t0
        done, ctx.trace = trace.profiled_calls(drv.call, n, device, sync)
        ctx.window_s = ctx.trace.wall_s
        ctx.calls = len(done)
        ctx.units = sum(u for u, _ in done)
        ctx.work = sum(w for _, w in done)
    else:
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            units, work = drv.call()
            end = time.perf_counter()
            ctx.latencies_s.append(end - t)
            ctx.calls += 1
            ctx.units += units
            ctx.work += work
            if end - t0 >= seconds:
                break
        ctx.window_s = end - t0
    dev_info = device_info(device, cell.chips)
    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values = drv.check()
    correct, checks = verdict(values, cell.limits)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.metric_reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = None
    if traced:
        dev_info["busy_s"] = ctx.trace.busy_s
        dev_info["window_s"] = ctx.trace.wall_s
        breakdown = {"device_ops": ctx.trace.device_ops,
                     "idle_gaps": ctx.trace.idle_gaps}
    # a call that fails raises and ends the run: none is counted failed
    return Result(correct, ctx.calls, 0, metrics, dev_info, checks,
                  breakdown)


def verdict(values: dict, limits: dict):
    """(correct, {name: {value, limit}}): correct where every number that
    has a limit is at most it, and there is one."""
    checks = {name: {"value": float(values[name]), "limit": limit}
              for name, limit in limits.items()}
    return bool(checks) and all(c["value"] <= c["limit"]
                                for c in checks.values()), checks


def p95(values) -> float:
    """The 95th percentile (the exclusive method of ``statistics``)."""
    return statistics.quantiles(values, n=20)[-1]
