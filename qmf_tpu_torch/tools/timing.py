"""Timing helpers shared by the decomposition probes (tools/bpr_decomp.py,
tools/bpr_grouped_micro.py): a part captured as a CUDA graph, and parts
timed in turns, one call of each a round."""

from __future__ import annotations

import time

import torch

from qmf_tpu_torch.ops import graphs


def captured(fn, device: torch.device) -> tuple:
    """(call, nodes): ``fn`` as the epoch runs it, on a card captured as a
    CUDA graph (graphs.EpochGraph: its first call the warm-up and the
    capture) and replayed, so that the part is paced by the device as the
    replayed epoch is, not by the host's launches, with the graph's node
    count; on the CPU ``fn`` itself and None. ``fn`` reads its tensors
    where they lie; the graph's one input is a placeholder."""
    if device.type != "cuda":
        return fn, None
    token = torch.zeros(1, device=device)
    graph = graphs.EpochGraph(lambda _: fn())
    graph(token)
    return (lambda: graph.replay(token)), graph.nodes


def call_ms(fn, device: torch.device) -> float:
    """ms of one call of ``fn``: CUDA events on a card, the host's clock on
    the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def in_turns(fns: dict, device: torch.device, reps: int) -> dict:
    """``{name: [ms, ...]}``: after one warm-up call of each of ``fns``,
    ``reps`` rounds of one timed call of each in turn."""
    for fn in fns.values():
        fn()
    out = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            out[name].append(call_ms(fn, device))
    return out
