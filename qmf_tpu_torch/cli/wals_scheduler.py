"""``wals_scheduler`` CLI of the PyTorch port (reference
qmf/wals_scheduler.cpp:27-75; qmf_tpu/cli/wals_scheduler.py).

Starts the job-queue scheduler daemon. Same default bind (0.0.0.0:8900) and
flag names as the reference and qmf_tpu, plus ``--device`` (every worker
rank's device, default "cuda") and ``--backend`` (default empty: NCCL for a
card, gloo for the CPU)::

    python -m qmf_tpu_torch.cli.wals_scheduler
    python -m qmf_tpu_torch.cli.wals_scheduler --n_local_devices=1  # CPU
    python -m qmf_tpu_torch.cli.wals_scheduler --backend=gloo --device=cuda:0

The last form lets the scheduler's worker and one labor's share one card.
qmf_tpu's JAX platform and compile-cache settings (qmf_tpu/cli/common.py)
have no counterpart here.
"""

from __future__ import annotations

import asyncio
import signal
import sys

from qmf_tpu_torch.distributed.scheduler import Scheduler
from qmf_tpu_torch.utils.flags import Flags
from qmf_tpu_torch.utils.logging import log


def make_flags() -> Flags:
    fl = Flags("wals_scheduler")
    fl.define_string("scheduler_ip", "0.0.0.0", "scheduler bind address")
    fl.define_integer("scheduler_port", 8900, "scheduler bind port")
    # multi-process training over attached labors (one process group)
    fl.define_bool(
        "multiproc",
        True,
        "co-train across attached labors in one torch.distributed group",
    )
    fl.define_string(
        "coordinator_ip",
        "127.0.0.1",
        "address labors use to reach this host's process-group coordinator",
    )
    fl.define_integer(
        "n_local_devices",
        0,
        "1 = every worker rank on the CPU over gloo (0 = --device)",
    )
    fl.define_string("device", "cuda",
                     "every worker rank's torch device: cuda | cuda:N | cpu")
    fl.define_string(
        "backend", "",
        "process-group backend: nccl | gloo (default: nccl for a card, gloo "
        "for the CPU; ranks sharing one card need gloo and cuda:N)",
    )
    return fl


def main(argv=None) -> int:
    fl = make_flags()
    fl.parse(argv)
    scheduler = Scheduler(
        fl.scheduler_ip,
        fl.scheduler_port,
        multiproc=fl.multiproc,
        coordinator_host=fl.coordinator_ip,
        n_local_devices=fl.n_local_devices,
        device=fl.device,
        backend=fl.backend,
    )

    async def _run():
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGUSR1):
            loop.add_signal_handler(sig, stop.set)
        await scheduler.start()
        log.info("scheduler ready; submit tasks with wals_submit")
        await stop.wait()
        log.info("signal received, terminating...")
        await scheduler.stop()

    asyncio.run(_run())
    return 0


if __name__ == "__main__":
    sys.exit(main())
