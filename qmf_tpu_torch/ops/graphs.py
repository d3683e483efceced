"""One-program epochs on a CUDA device: an epoch captured once as a CUDA
graph and replayed (the port's counterpart of qmf_tpu's jitted epoch and of
its ``lax.scan`` over a run, qmf_tpu/ops/als_ops.py:509-637).

This module is the only one that touches ``torch.cuda.CUDAGraph``. An
:class:`EpochGraph` wraps a callable whose inputs and outputs are tensors on
one CUDA device. Its first call runs the callable eagerly on a side stream
(the warm-up: a real call, whose results are returned), then captures it on
that stream into a private memory pool; every later call copies its inputs
into the graph's static input buffers and replays the graph on the current
stream. Nothing on the path may read a device value on the host, allocate
outside PyTorch's allocator, or synchronise: the epochs of both engines hold
to that.

The kernels' wrappers count their launches in Python, each counter
registered with ``kernels.register_counter`` (``spd_solve.launches`` and
``launches_t``, ``build_solve.launches`` and ``launches_hot``,
``gather.launches``), as the mesh counts its collectives (``Mesh.counts``).
A capture passes through the wrappers once without launching, and a replay
launches without passing through them. So the graph takes back what every
registered counter gained during the capture and adds it again at every
replay: a replayed epoch counts what an eager epoch counts.

Whether an engine captures is decided once, before its first epoch, by
:func:`eager_reasons` from the device, the mesh's backend and the solver,
and logged (:func:`epoch_program`). A capture or replay that fails raises;
nothing retries eagerly.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import torch

from qmf_tpu_torch import kernels
from qmf_tpu_torch.utils.logging import log

# WALS solvers whose epoch is not captured, with the reason, as found on an
# H100 (torch 2.11, CUDA 12.8): the capture ends in
# cudaErrorStreamCaptureInvalidated ("operation failed due to a previous
# error during capture"). tests/test_torch_kernels.py
# ``test_uncaptured_solvers_table_holds`` holds the table on a card: a
# listed solver must be refused, an unlisted one must capture.
UNCAPTURED_SOLVERS = {
    "cholesky": "the library's batched cholesky_ex + cholesky_solve "
                "invalidates a CUDA graph capture (at 13 and 8,192 systems "
                "of k = 64)",
    "lu": "the library's batched solve_ex invalidates a CUDA graph capture "
          "(at 8,192 systems of k = 64; it captures at 13)",
}

# Process-group backends whose collectives are not captured, with the
# reason.
UNCAPTURED_BACKENDS = {
    "gloo": "gloo runs its collectives on the host, which a CUDA graph "
            "cannot hold",
}


def eager_reasons(device: torch.device, backend: str = "none",
                  solver: Optional[str] = None) -> List[str]:
    """Why an engine's epochs run as eager ops and are not captured: empty
    where they are captured. ``backend`` is the mesh's ("none" without a
    process group) and ``solver`` the resolved WALS solver (None for BPR)."""
    reasons = []
    if torch.device(device).type != "cuda":
        reasons.append(f"{device} is not a CUDA device")
    if backend in UNCAPTURED_BACKENDS:
        reasons.append(UNCAPTURED_BACKENDS[backend])
    if solver in UNCAPTURED_SOLVERS:
        reasons.append(f"solver {solver!r}: {UNCAPTURED_SOLVERS[solver]}")
    return reasons


def epoch_program(name: str, body: Callable, device: torch.device,
                  mesh=None, solver: Optional[str] = None):
    """``body`` as an engine's one program: an :class:`EpochGraph` of it
    where :func:`eager_reasons` finds nothing against a capture, else
    ``body`` itself, run as eager ops. Logs which, under ``name``. Returns
    (program, the reasons it runs eagerly)."""
    reasons = eager_reasons(device, "none" if mesh is None else mesh.backend,
                            solver)
    if reasons:
        log.info("%s runs as eager ops: %s", name, "; ".join(reasons))
        return body, reasons
    log.info("%s: a CUDA graph on %s, captured at its first call", name,
             device)
    return EpochGraph(body, mesh), reasons


class EpochGraph:
    """``fn`` captured as a CUDA graph at its first call and replayed at
    every later one.

    ``fn(*inputs)`` takes and returns tensors on one CUDA device; it may
    update an input in place. The first call clones its inputs into the
    graph's static buffers, runs ``fn`` on them eagerly (the warm-up),
    captures ``fn`` on them and returns the warm-up's outputs. A later call
    copies each input into its buffer (none where it is the buffer itself:
    an input ``fn`` updates in place, or an output of the last replay fed
    back) and returns the static outputs, which the next call overwrites.
    ``mesh`` is the engine's mesh, whose collective counts are kept true.
    """

    def __init__(self, fn: Callable, mesh=None):
        self._fn = fn
        self._mesh = mesh
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._inputs: List[torch.Tensor] = []
        self._outputs = None
        self._delta: List[int] = []
        # seconds to record the capture and to end it (instantiation), and
        # the replays so far
        self.record_s: Optional[float] = None
        self.instantiate_s: Optional[float] = None
        self.replays = 0

    @property
    def capture_s(self) -> Optional[float]:
        """Seconds of the capture, instantiation included."""
        if self.record_s is None:
            return None
        return self.record_s + self.instantiate_s

    @property
    def inputs(self) -> List[torch.Tensor]:
        """The static input buffers (empty before the first call)."""
        return self._inputs

    def _counts(self) -> List[int]:
        counts = kernels.read_counters()
        if self._mesh is not None:
            counts += [self._mesh.counts[k] for k in sorted(self._mesh.counts)]
        return counts

    def _set_counts(self, counts: Sequence[int]) -> None:
        n = len(counts) - (0 if self._mesh is None else len(self._mesh.counts))
        kernels.write_counters(counts[:n])
        if self._mesh is not None:
            for k, c in zip(sorted(self._mesh.counts), counts[n:]):
                self._mesh.counts[k] = c

    def __call__(self, *inputs: torch.Tensor):
        if self._graph is None:
            return self._capture(inputs)
        return self.replay(*inputs)

    def _capture(self, inputs):
        device = inputs[0].device
        if device.type != "cuda":
            raise ValueError(f"EpochGraph captures on a CUDA device, not "
                             f"{device}")
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            # the warm-up initialises, on the capture stream, what the
            # libraries create at a first call (handles, workspaces)
            self._inputs = [t.clone() for t in inputs]
            warm = self._fn(*self._inputs)
        current.wait_stream(side)
        before = self._counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # thread_local: the capture refuses unsafe calls of this thread
        # alone, and leaves other threads' (NCCL's watchdog) alone
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            outputs = self._fn(*self._inputs)
            t1 = time.perf_counter()
        self.instantiate_s = time.perf_counter() - t1
        self.record_s = t1 - t0
        after = self._counts()
        self._set_counts(before)
        self._delta = [a - b for a, b in zip(after, before)]
        self._graph, self._outputs = graph, outputs
        return warm

    def replay(self, *inputs: torch.Tensor):
        """Copy ``inputs`` into the static buffers and replay on the current
        stream; returns the static outputs."""
        if self._graph is None:
            raise RuntimeError("EpochGraph.replay before the first call "
                               "captured it")
        if len(inputs) != len(self._inputs):
            raise ValueError(f"{len(inputs)} inputs, the graph was captured "
                             f"with {len(self._inputs)}")
        for static, new in zip(self._inputs, inputs):
            if new is static:
                continue
            if new.shape != static.shape or new.dtype != static.dtype:
                raise ValueError(
                    f"input {tuple(new.shape)} {new.dtype}, the graph was "
                    f"captured with {tuple(static.shape)} {static.dtype}")
            static.copy_(new)
        self._graph.replay()
        self.replays += 1
        self._set_counts([c + d for c, d in zip(self._counts(),
                                                self._delta)])
        return self._outputs
