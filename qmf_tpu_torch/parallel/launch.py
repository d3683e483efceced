"""Start the ranks of a sharded run on this host.

JAX drives every device from one process; PyTorch runs one process per
rank. :func:`spawn` starts ``n`` of them with ``torch.multiprocessing``'s
spawn method on a free local port, joins each to one process group, calls
``fn(mesh, *args)`` in each and waits for all of them, against a deadline
unless it is None: if a rank fails or the deadline passes, every rank is
killed and the call raises. The training CLIs (:func:`run_cli`) wait with
no deadline, as qmf_tpu's ``--n_devices`` does; the dry run and the tests
keep one. The group's own timeouts (multihost.GROUP_TIMEOUT_S,
COLLECTIVE_TIMEOUT_S) bound the rendezvous and each collective. ``fn`` must
be importable by name (a module-level function of the package), since
spawned ranks import it afresh; results go through files.

    from qmf_tpu_torch.parallel import launch
    launch.spawn(train, 2, backend="gloo", device="cpu", args=(path,))
"""

from __future__ import annotations

import logging
import os
import socket
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from qmf_tpu_torch.parallel import multihost
from qmf_tpu_torch.parallel.mesh import available_devices, make_mesh
from qmf_tpu_torch.utils.logging import log

DEADLINE_S = 600.0


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, n: int, backend: Optional[str],
               device: str, port: int, threads: int, args: Sequence) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(threads)
    if rank != 0:
        log.setLevel(logging.WARNING)  # rank 0 logs
    multihost.initialize(f"127.0.0.1:{port}", n, rank, backend=backend,
                         device=device)
    try:
        fn(make_mesh(n, device=device), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, backend: Optional[str] = None,
          device: str = "cuda", args: Sequence = (),
          deadline_s: Optional[float] = DEADLINE_S) -> None:
    """Run ``fn(mesh, *args)`` on ``n`` new local ranks of one group.

    ``device`` is each rank's: the card by default ("cuda" gives rank r
    the card cuda:r; "cuda:0" puts every rank on card 0, which only gloo
    allows), the host with "cpu";
    ``backend`` defaults to NCCL for CUDA and gloo for the CPU. The CUDA
    kernels are built here first, so the ranks do not queue behind one
    nvcc run with the group's timeout running. Raises if a rank raises
    (with its traceback) or when ``deadline_s`` passes (None: no deadline).
    """
    dev = torch.device(device)
    if (backend or ("nccl" if dev.type == "cuda" else "gloo")) == "nccl" \
            and dev.index is not None and n > 1:
        raise ValueError(f"NCCL takes one card a rank: {n} ranks cannot "
                         f"share {dev}")
    if dev.type == "cuda":
        from qmf_tpu_torch import kernels

        if kernels.available():
            kernels.load()
    threads = max(1, torch.get_num_threads() // n)
    ctx = mp.start_processes(
        _rank_main, args=(fn, n, backend, device, free_port(), threads,
                          tuple(args)),
        nprocs=n, join=False, start_method="spawn")
    end = None if deadline_s is None else time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=1.0):
            if end is not None and time.monotonic() > end:
                raise TimeoutError(
                    f"{n} ranks of {fn.__module__}.{fn.__qualname__} still "
                    f"running after {deadline_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


def run_cli(rank_fn: Callable, n_devices: int, device: str,
            argv: Sequence[str]) -> Optional[int]:
    """``--n_devices`` of the training CLIs, as qmf_tpu reads it.

    Under torchrun (WORLD_SIZE set) this process joins torchrun's group and
    runs ``rank_fn(mesh, argv)`` as its rank; ``n_devices`` must then be 0
    or the world size. Otherwise 1 returns None (the caller trains on one
    device, in this process), N > 1 spawns N local ranks, one a card, and 0
    spawns one a visible CUDA device; on the CPU, which has no device
    count, 0 raises. Returns the exit code where ranks ran.
    """
    if "WORLD_SIZE" in os.environ:
        multihost.initialize(device=device)
        if dist.get_rank() != 0:
            log.setLevel(logging.WARNING)  # rank 0 logs
        try:
            rank_fn(make_mesh(n_devices or None, device=device), argv)
        finally:
            dist.destroy_process_group()
        return 0
    if n_devices == 1:
        return None
    n = n_devices
    if n == 0:
        n = available_devices(device)
        if n is None:
            raise ValueError(
                f"--n_devices=0 (every device) on --device={device}: the "
                "CPU has no device count; give the number of ranks")
    avail = available_devices(device)
    if avail is not None and n > avail or n < 1:
        raise ValueError(f"requested {n_devices} devices, only "
                         f"{avail} available")
    log.info("training on %d ranks (%s)", n, device)
    # a training run takes as long as it takes; a rank that raises still
    # ends it at once
    spawn(rank_fn, n, device=device, args=(list(argv),), deadline_s=None)
    return 0
