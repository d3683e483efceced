"""The traced window: a few whole calls under ``torch.profiler``, reduced to
the device's busy time, its operations by time and its idle gaps.

Busy time is the union of the device activity intervals (kernels, copies,
sets), so overlapping work counts once. An idle gap is named by what the
host was inside at its middle: the innermost span of the benchmark's own
(``portbench.*``) or the program's (``wals_run``, ``bpr_epoch_N``,
``serve_request``, ``serve_topn``; ``SPAN_PREFIXES``), and the innermost
host operation. The time between the first read call's start
and the device's first operation, and between its last operation and the
last call's end, counts as gaps too.

The profiler traces one lead-in call more than it reads, and everything is
read from the second call's span onward: the first call under a profiler
that has just started pays for its start (the leading launch from a synced
device, CUPTI's first buffers), which no call of a window pays.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

TOP = 10
# host events whose names start so are spans, the others host operations
SPAN_PREFIXES = ("portbench.", "wals_", "bpr_", "serve_")


@dataclass
class TraceSummary:
    wall_s: float
    busy_s: float = 0.0
    device_s: float = 0.0  # summed durations of the device activities
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_stretches(merged, start, end):
    """(length, from, to) of each stretch of [start, end] that the merged
    busy intervals leave idle (before the first, between two, after the
    last), longest first."""
    bounds = [start] + [x for iv in merged for x in iv] + [end]
    return sorted(((b - a, a, b) for a, b in zip(bounds[::2], bounds[1::2])
                   if b > a), reverse=True)


def is_span(name: str) -> bool:
    return name.startswith(SPAN_PREFIXES)


def _innermost(spans, t):
    best = None
    for s, e, name in spans:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else None


def _host_op(ops, t):
    """The innermost host operation around ``t``, else the last one that
    ended before it."""
    inside = _innermost(ops, t)
    if inside:
        return inside
    before = [(e, name) for s, e, name in ops if e <= t]
    return f"after {max(before)[1]}" if before else "no host op"


def profiled_calls(call, n_calls: int, device: torch.device, sync,
                   lead_in: int = 1):
    """Run ``call()`` ``lead_in + n_calls`` times under the profiler, each
    inside a ``portbench.call`` span, and read the last ``n_calls``.
    Returns (those calls' results, their TraceSummary)."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    results = []
    sync()
    with profile(activities=acts) as prof:
        for _ in range(lead_in + n_calls):
            with record_function("portbench.call"):
                results.append(call())
        sync()
    events = prof.events()
    # a span (record_function) is mirrored on the device's timeline as an
    # annotation: it is no device work
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    spans, ops = [], []
    for e in events:
        if e.device_type == DeviceType.CPU:
            (spans if is_span(e.name) else ops).append(
                (e.time_range.start, e.time_range.end, e.name))
    calls = sorted((s, t) for s, t, name in spans if name == "portbench.call")
    calls = calls[lead_in:]
    lo, hi = calls[0][0], calls[-1][1]
    dev_iv, by_name = [], {}
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA and t > s and s >= lo and \
                e.name not in host_names and \
                not getattr(e, "is_user_annotation", False):
            dev_iv.append((s, t))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) / 1e6
            hi = max(hi, t)
    summary = TraceSummary(wall_s=(hi - lo) / 1e6)
    results = results[lead_in:]
    if not dev_iv:
        return results, summary
    merged = union(dev_iv)
    summary.busy_s = sum(e - s for s, e in merged) / 1e6
    summary.device_s = sum(by_name.values())
    summary.device_ops = sorted(([n[:120], v] for n, v in by_name.items()),
                                key=lambda x: -x[1])[:TOP]
    gaps = idle_stretches(merged, lo, hi)[:TOP]
    for length, s, t in gaps:
        mid = (s + t) / 2
        name = f"{_innermost(spans, mid) or 'no span'} / " \
               f"{_host_op(ops, mid)}"
        summary.idle_gaps.append([name[:160], length / 1e6])
    return results, summary
