"""Shares of a traced run's calls' work: the least time the chip could take
for it (the larger of its FLOPs over the float32 peak and its bytes over
the memory bandwidth, ``portbench/peaks.json``) over the device time of
the traced calls' operations (a roofline share), or over the host's wall
time of the same number of calls untraced (the whole step's share of the
peak, ``mfu``: the profiler stretches a traced call's wall, most where a
call runs many small kernels); and the device's idle share of the traced
window. None where nothing was read on a device of known peaks."""

from __future__ import annotations


def least_time_s(ctx, work):
    p = ctx.peaks
    return work * max(ctx.flops_per_work / p["float32_flops_per_s"],
                          ctx.bytes_per_work / p["bytes_per_s"])


def roofline(ctx):
    if ctx.trace is None or not ctx.trace.device_s or ctx.peaks is None:
        return None
    return 100.0 * least_time_s(ctx, ctx.work) / ctx.trace.device_s


def mfu(ctx):
    if not ctx.untraced_s or ctx.peaks is None:
        return None
    return 100.0 * least_time_s(ctx, ctx.untraced_work) / ctx.untraced_s


def idle_share(ctx):
    if ctx.trace is None or not ctx.trace.busy_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.wall_s)
