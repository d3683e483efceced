"""Profiling / tracing hooks (the port's counterpart of
qmf_tpu/utils/tracing.py).

The reference's only observability was per-bucket wall-time logs
(reference distributed/scheduler/Connection.cpp:296-298) and byte-level
VLOG traces (SURVEY.md section 5.1). Here profiling is first-class:

- :func:`trace` — context manager around ``torch.profiler`` trace capture
  (host ops, and the card's kernels once CUDA is initialized), written as a
  Chrome trace that chrome://tracing or Perfetto opens (QMF_TPU_TRACE_DIR
  or explicit path, as in qmf_tpu).
- :func:`annotate` — named ``record_function`` regions while a profiler
  records, and NVTX ranges once CUDA is initialized, so epochs show up
  labeled on the timeline; each one is also kept in memory as a host span
  (:data:`HOST`).
- :func:`part` — an :func:`annotate` region that is also stamped on the
  device's clock at entry and exit, by a kernel on a CUDA device (so a
  replayed CUDA graph stamps it at every replay) and on the host's clock
  elsewhere. :func:`device_spans` reads the stamps as spans, and
  :func:`children_ms` sums a part's instances inside each instance of an
  enclosing part; :func:`in_calls` keeps the instances of a program's
  steady calls that no profiler recorded, one population to take a
  median over.
- :class:`StepTimer` — lightweight wall-clock records (copy of qmf_tpu's),
  the moral upgrade of the reference's "time cost N secs" log lines,
  queryable after a run; an instance of it, :data:`HOST`, is the bounded
  store of the host spans.

Both kinds of span are read on the clock of ``torch.profiler``'s host
events (``time.time_ns``), each brought onto it by one paired reading of
its own clock at read time, so a span lines up with a profiled trace. The
program's spans (host, and parts):

| span | where | part |
| --- | --- | --- |
| ``wals_run``, ``wals_epoch_N`` | ``models/wals.py`` ``optimize`` | no |
| ``wals_epoch`` | ``ops/als_ops.py`` ``epoch_body``: both half-epochs | yes |
| ``wals_build`` / ``wals_solve`` | each class's chunked build / its batched solve and loss (a chunk each with ``class_solve=False``) | yes |
| ``wals_build_solve`` | each class of the fused solver | yes |
| ``bpr_epoch_N``, ``bpr_launch``, ``bpr_wait`` | ``models/bpr.py``: the epoch; its program's call; the finiteness read | no |
| ``bpr_epoch`` > ``bpr_pass1``, ``bpr_sgd`` | ``ops/bpr_ops.py`` ``grouped_epoch`` | yes |
| ``bpr_eval`` | ``models/bpr.py`` each eval loss | yes |
| ``serve_request`` > ``serve_scores``, ``serve_seen``, ``serve_topn`` | ``models/recommend.py`` ``recommend_top_n`` | yes |
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from qmf_tpu_torch.utils.logging import log

# the newest host spans kept, and the stamps a device's ring (or the host's
# stamp store) holds, the newest overwriting the oldest
SPAN_CAPACITY = 1 << 16
RING_ENTRIES = 1 << 16


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


class Span(NamedTuple):
    """A host span: its name, start and end in ns, the name of the span
    open around it on its thread (None at the top), and whether a profiler
    was recording when it opened."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    profiled: bool


class StepTimer:
    """Named wall-clock records: ``with timer.measure("epoch"): ...``; and
    host spans, ``with timer.span("name"): ...``, the newest ``capacity``
    kept in ``spans`` on ``time.perf_counter_ns``."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.records: Dict[str, List[float]] = {}
        self.spans: collections.deque = collections.deque(maxlen=capacity)
        self._local = threading.local()

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.records.setdefault(name, []).append(time.time() - t0)

    def span(self, name: str, profiled: Optional[bool] = None):
        """Record the block as a :class:`Span`, also when it raises.
        ``profiled``: whether a profiler records (None: ask torch)."""
        return _HostSpan(self, name, profiled)

    def summary(self) -> Dict[str, Tuple[int, float, float]]:
        """{name: (count, total_s, mean_s)}"""
        return {
            k: (len(v), sum(v), sum(v) / len(v))
            for k, v in self.records.items()
        }

    def log_summary(self) -> None:
        for name, (n, total, mean) in sorted(self.summary().items()):
            log.info("timing %s: n=%d total=%.3fs mean=%.4fs", name, n, total, mean)


class _HostSpan:
    """:meth:`StepTimer.span`'s context: a class and not a generator, being
    on the host's path of every :func:`part`."""

    __slots__ = ("_timer", "_name", "_profiled", "_stack", "_parent", "_t0")

    def __init__(self, timer: StepTimer, name: str, profiled: Optional[bool]):
        self._timer, self._name, self._profiled = timer, name, profiled

    def __enter__(self):
        local = self._timer._local
        stack = local.__dict__.get("open")
        if stack is None:
            stack = local.open = []
        if self._profiled is None:
            self._profiled = _profiling()
        self._stack, self._parent = stack, stack[-1] if stack else None
        stack.append(self._name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self._stack.pop()
        self._timer.spans.append(
            Span(self._name, self._t0, t1, self._parent, self._profiled))
        return False


def _profiling() -> bool:
    import torch

    return torch._C._autograd._profiler_enabled()


# the host spans every annotate() records
HOST = StepTimer()


class annotate:
    """Label a region on the profiler timeline, and keep it as a host span
    in :data:`HOST`: ``with annotate("name"): ...``. NVTX ranges once CUDA
    is initialized. Without a profiler recording, no ``record_function``
    is opened (nothing would read it, and it costs the host tens of
    microseconds, which a serving request waits for)."""

    __slots__ = ("_name", "_nvtx", "_label", "_span")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        import torch

        profiled = _profiling()
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self._name)
        self._label = None
        if profiled:
            self._label = torch.profiler.record_function(self._name)
            self._label.__enter__()
        self._span = HOST.span(self._name, profiled)
        self._span.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._span.__exit__(*exc)
        if self._label is not None:
            self._label.__exit__(*exc)
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
        return False


def _host_to_profiler_ns() -> int:
    """What to add to a ``perf_counter_ns`` reading to put it on the
    profiler's host clock (``time.time_ns``): one paired reading."""
    return time.time_ns() - time.perf_counter_ns()


def host_spans(name: Optional[str] = None) -> List[Span]:
    """The kept host spans (of ``name``, else all), oldest first, on the
    profiler's host clock."""
    shift = _host_to_profiler_ns()
    return [s._replace(start_ns=s.start_ns + shift, end_ns=s.end_ns + shift)
            for s in list(HOST.spans) if name is None or s.name == name]


# Parts: a part's id is its index in _part_names; a stamp's tag is
# 2 * id at entry, 2 * id + 1 at exit.
_part_names: List[str] = []
_part_ids: Dict[str, int] = {}
_part_lock = threading.Lock()
# the stamps of parts on a host device: (tag, perf_counter_ns)
_host_stamps: collections.deque = collections.deque(maxlen=RING_ENTRIES)
# per CUDA device index: (ring (RING_ENTRIES, 2) int64, write count (1,)),
# and its stamp launcher (None where the kernel library does not load)
_rings: Dict[int, tuple] = {}
_launchers: Dict[int, Optional[Callable[[int], None]]] = {}
# per (name, device) as part() was given them: the part's stamp, called
# with 0 at entry and 1 at exit; None where the part is not stamped
_stampers: Dict[tuple, Optional[Callable[[int], None]]] = {}


def _part_tag(name: str) -> int:
    with _part_lock:
        if name not in _part_ids:
            _part_ids[name] = len(_part_names)
            _part_names.append(name)
        return 2 * _part_ids[name]


def _launcher(index: int) -> Optional[Callable[[int], None]]:
    """The stamp launcher of CUDA device ``index``, its ring made at its
    first (eager) use; None, with one warning, where the kernel library
    does not load: that device's parts are then host spans alone."""
    import torch

    from qmf_tpu_torch import kernels

    if index in _launchers:
        return _launchers[index]
    try:
        kernels.load()
    except Exception as e:  # a hook never fails the path it observes
        log.warning("part(): no stamps on cuda:%d, the kernel library did "
                    "not load (%s); parts there are host spans alone",
                    index, e)
        _launchers[index] = None
        return None
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"part() under a CUDA graph capture before any eager part() "
            f"on cuda:{index}: the stamp ring is made at the first eager "
            f"call (an EpochGraph's warm-up)")
    dev = torch.device("cuda", index)
    ring = (torch.zeros((RING_ENTRIES, 2), dtype=torch.int64, device=dev),
            torch.zeros((1,), dtype=torch.int64, device=dev))
    _rings[index] = ring
    _launchers[index] = kernels.stamp_launcher(*ring)
    return _launchers[index]


def _stamper(name: str, device) -> Optional[Callable[[int], None]]:
    """The stamp of part ``name`` on ``device`` (made at its first use, a
    bare "cuda" bound to the device current then)."""
    key = (name, device)
    if key in _stampers:
        return _stampers[key]
    import torch

    dev = torch.device(device)
    tag = _part_tag(name)
    if dev.type != "cuda":
        def stamp(leaving: int) -> None:
            _host_stamps.append((tag + leaving, time.perf_counter_ns()))
    else:
        launch = _launcher(torch.cuda.current_device() if dev.index is None
                           else dev.index)
        stamp = None if launch is None else \
            (lambda leaving: launch(tag + leaving))
    _stampers[key] = stamp
    return stamp


def part(name: str, device) -> "_Part":
    """An :func:`annotate` region whose work on ``device`` is also stamped:
    on a CUDA device by csrc/stamp.cu on the current stream at entry and at
    exit (eager, or as two nodes of a graph being captured, which stamp at
    every replay; no host read, sync or allocation after the part's first
    use), elsewhere on the host's clock. A block that raises leaves no
    instance. Where the kernel library does not load, a part on the card
    is its host span alone. Read with :func:`device_spans`."""
    return _Part(name, _stamper(name, device))


class _Part:
    __slots__ = ("_stamp", "_label")

    def __init__(self, name: str, stamp):
        self._stamp, self._label = stamp, annotate(name)

    def __enter__(self):
        self._label.__enter__()
        if self._stamp is not None:
            try:
                self._stamp(0)
            except BaseException:
                self._label.__exit__(None, None, None)
                raise
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        try:
            if exc_type is None and self._stamp is not None:
                self._stamp(1)
        finally:
            self._label.__exit__(exc_type, *exc)
        return False


def _paired(stamps, shift: int) -> List[Tuple[str, int, int]]:
    """(name, start, end) of each instance in ``stamps`` ((tag, ns) in the
    order written), each exit closing the latest open entry of its part;
    ``shift`` added to every time."""
    open_: Dict[int, List[int]] = {}
    out = []
    for tag, ns in stamps:
        pid, leaving = divmod(tag, 2)
        if not leaving:
            open_.setdefault(pid, []).append(ns)
        elif open_.get(pid):
            out.append((_part_names[pid], open_[pid].pop() + shift,
                        ns + shift))
    return out


def _device_to_profiler_ns(device) -> int:
    """What to add to a reading of ``device``'s clock to put it on the
    profiler's host clock: the host's clock read before and after a stamp
    on an idle device, the middle of the tightest of five pairs."""
    import torch

    from qmf_tpu_torch import kernels

    ring = torch.zeros((1, 2), dtype=torch.int64, device=device)
    stamp = kernels.stamp_launcher(
        ring, torch.zeros((1,), dtype=torch.int64, device=device))
    best = None
    for _ in range(5):
        torch.cuda.synchronize(device)
        t0 = time.time_ns()
        stamp(0)
        torch.cuda.synchronize(device)
        t1 = time.time_ns()
        shift = (t0 + t1) // 2 - int(ring[0, 1])
        if best is None or t1 - t0 < best[0]:
            best = (t1 - t0, shift)
    return best[1]


def _spans_by_clock() -> List[List[Tuple[str, int, int]]]:
    """The parts' instances of each clock (the host's, then each CUDA
    device's), each list sorted by start, on the profiler's host clock.
    Waits for each device and copies its ring once."""
    import torch

    clocks = [_paired(list(_host_stamps), _host_to_profiler_ns())]
    for ring, count in _rings.values():
        torch.cuda.synchronize(ring.device)
        n = int(count)
        rows = ring.tolist()
        stamps = [rows[i % len(rows)] for i in range(max(0, n - len(rows)),
                                                     n)]
        clocks.append(_paired(stamps, _device_to_profiler_ns(ring.device)))
    for spans in clocks:
        spans.sort(key=lambda s: s[1])
    return clocks


def device_spans(name: Optional[str] = None) -> List[Tuple[str, int, int]]:
    """Every kept instance of the parts (of ``name``, else all) as (name,
    start_ns, end_ns) on the profiler's host clock, sorted by start: the
    device's stamps on a card, the host's elsewhere. Reading waits for the
    devices; nothing is read during a call."""
    spans = [s for clock in _spans_by_clock() for s in clock
             if name is None or s[0] == name]
    return sorted(spans, key=lambda s: s[1])


def in_calls(instances: list, call: str, skip: int = 1) -> list:
    """Those of ``instances`` (parts' instances or host spans: tuples whose
    [1] and [2] are start and end ns on the profiler's host clock) that ran
    in a steady call with no profiler recording. A call is a host span
    whose name starts with ``call``; an instance belongs to the call opened
    last before its middle (a call waits for its device work, so what it
    ran ends before the next call opens). Left out: the program's first
    ``skip`` calls (its warm-up: the eager first run and, on a card, the
    capture; with 2, also a CUDA graph's first replay, slower than the
    later ones) and every call opened while a profiler recorded."""
    calls = sorted((s for s in host_spans() if s.name.startswith(call)),
                   key=lambda s: s.start_ns)
    opens = [s.start_ns for s in calls]
    out = []
    for inst in instances:
        i = bisect.bisect_right(opens, (inst[1] + inst[2]) // 2) - 1
        if i >= skip and not calls[i].profiled:
            out.append(inst)
    return out


def span_ms(name: str, call: Optional[str] = None,
            skip: int = 1) -> List[float]:
    """The ms of each instance of the part ``name``, in order of start;
    with ``call``, of those :func:`in_calls` keeps."""
    spans = device_spans(name)
    if call is not None:
        spans = in_calls(spans, call, skip)
    return [(e - s) / 1e6 for _, s, e in spans]


def children_ms(parent: str, child: str, call: Optional[str] = None,
                skip: int = 1) -> List[float]:
    """For each instance of the part ``parent``, in order of start (with
    ``call``, each that :func:`in_calls` keeps), the summed ms of the
    instances of ``child`` that lie inside it on the same clock (a span's
    parent is the span that encloses it)."""
    out = []
    for spans in _spans_by_clock():
        kids = [s for s in spans if s[0] == child]
        starts = [s for _, s, _ in kids]
        parents = [p for p in spans if p[0] == parent]
        if call is not None:
            parents = in_calls(parents, call, skip)
        for _, s, e in parents:
            inside = kids[bisect.bisect_left(starts, s):
                          bisect.bisect_right(starts, e)]
            out.append(sum(ke - ks for _, ks, ke in inside if ke <= e) / 1e6)
    return out


def clear() -> None:
    """Forget every kept host span and stamp (not under a capture)."""
    HOST.spans.clear()
    _host_stamps.clear()
    for _, count in _rings.values():
        count.zero_()
