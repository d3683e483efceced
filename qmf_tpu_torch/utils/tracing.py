"""Profiling / tracing hooks (the port's counterpart of
qmf_tpu/utils/tracing.py).

The reference's only observability was per-bucket wall-time logs
(reference distributed/scheduler/Connection.cpp:296-298) and byte-level
VLOG traces (SURVEY.md section 5.1). Here profiling is first-class:

- :func:`trace` — context manager around ``torch.profiler`` trace capture
  (host ops, and the card's kernels once CUDA is initialized), written as a
  Chrome trace that chrome://tracing or Perfetto opens (QMF_TPU_TRACE_DIR
  or explicit path, as in qmf_tpu).
- :func:`annotate` — named ``record_function`` regions, and NVTX ranges
  once CUDA is initialized, so epochs show up labeled on the timeline.
- :class:`StepTimer` — lightweight wall-clock records (copy of qmf_tpu's),
  the moral upgrade of the reference's "time cost N secs" log lines,
  queryable after a run.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple

from qmf_tpu_torch.utils.logging import log


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None):
    """Capture a torch.profiler trace around the enclosed block and write it
    to ``trace_dir`` (default: QMF_TPU_TRACE_DIR; neither set: no trace)."""
    trace_dir = trace_dir or os.environ.get("QMF_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str):
    """Label a region on the profiler timeline (cheap when untraced)."""
    import torch

    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Named wall-clock records: ``with timer.measure("epoch"): ...``."""

    def __init__(self):
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.records.setdefault(name, []).append(time.time() - t0)

    def summary(self) -> Dict[str, Tuple[int, float, float]]:
        """{name: (count, total_s, mean_s)}"""
        return {
            k: (len(v), sum(v), sum(v) / len(v))
            for k, v in self.records.items()
        }

    def log_summary(self) -> None:
        for name, (n, total, mean) in sorted(self.summary().items()):
            log.info("timing %s: n=%d total=%.3fs mean=%.4fs", name, n, total, mean)
