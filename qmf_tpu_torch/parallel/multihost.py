"""Joining a multi-process (and multi-host) sharded run.

Every rank runs the same program; the ranks meet at a coordinator address
and form one ``torch.distributed`` process group (qmf_tpu's
``jax.distributed`` rendezvous, qmf_tpu/parallel/multihost.py). Under
torchrun nothing needs passing: the arguments default to its environment.

    torchrun --nproc_per_node=4 -m qmf_tpu_torch.cli.wals --n_devices=4 ...

or, from Python, once per rank:

    from qmf_tpu_torch.parallel import ShardedWALSEngine, multihost
    multihost.initialize("10.0.0.1:29500", num_processes=8, process_id=r)
    engine = ShardedWALSEngine(cfg, mesh=multihost.global_mesh())
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from qmf_tpu_torch.parallel.mesh import local_rank, make_mesh, rank_device
from qmf_tpu_torch.utils.logging import log

# How long the rendezvous waits for every rank to join.
GROUP_TIMEOUT_S = 60
# How long a collective waits for the other ranks. Rank 0 alone writes
# checkpoints and factor files and evaluates, while the others wait in their
# next collective (the worker's final barrier, the next epoch's first
# all_gather; under NCCL the watchdog holds a barrier to this too), so the
# bound is sized for that I/O (7.7 s at ml20m, k = 64), not for finding a
# failed rank; qmf_tpu's sync_global_devices has no bound at all. A rank
# that dies is found by what started the ranks (launch.spawn, torchrun, the
# scheduler's failure detection).
COLLECTIVE_TIMEOUT_S = 1800


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Optional[str | torch.device] = None,
) -> None:
    """Join the process group (nothing to do with no coordinator).

    ``coordinator`` ("host:port") defaults to MASTER_ADDR:MASTER_PORT,
    ``num_processes`` to WORLD_SIZE, ``process_id`` to RANK: torchrun's
    environment. ``device`` (default "cuda") is this rank's device, a bare
    "cuda" the card of its LOCAL_RANK; ``backend`` defaults to NCCL for a
    CUDA device and gloo for the CPU. The card is made current before the
    group starts: NCCL ranks left on device 0 together hang. The rendezvous
    waits GROUP_TIMEOUT_S for the other ranks, each collective
    COLLECTIVE_TIMEOUT_S.
    """
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator is None:
        log.info("multihost: no coordinator configured, single-process mode")
        return
    num = int(num_processes if num_processes is not None
              else os.environ.get("WORLD_SIZE", "1"))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", "0"))
    dev = rank_device(device or "cuda", local_rank(rank))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # init_process_group's own rendezvous, with a timeout of its own
    store, _, _ = next(dist.rendezvous(
        f"tcp://{coordinator}", rank, num,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S)))
    collective = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    store.set_timeout(collective)
    dist.init_process_group(backend, store=store, world_size=num, rank=rank,
                            timeout=collective)
    log.info("multihost: joined as rank %d/%d (coordinator %s, %s, %s)",
             rank, num, coordinator, backend, dev)


def global_mesh(device: Optional[str | torch.device] = None):
    """The Mesh of this rank over every rank of the group."""
    return make_mesh(device=device)


def is_coordinator() -> bool:
    """True on rank 0, and in a single-process run."""
    return not dist.is_initialized() or dist.get_rank() == 0
