"""``wals_labor`` CLI of the PyTorch port (reference
qmf/wals_labor.cpp:26-71; qmf_tpu/cli/wals_labor.py).

Starts a labor agent that attaches to the scheduler. Same defaults
(127.0.0.1:8900) and flag names as the reference. Reconnects with backoff
if the scheduler goes away (the reference labor simply exited).
"""

from __future__ import annotations

import asyncio
import sys

from qmf_tpu_torch.distributed.labor import Labor
from qmf_tpu_torch.utils.flags import Flags
from qmf_tpu_torch.utils.logging import log


def make_flags() -> Flags:
    fl = Flags("wals_labor")
    fl.define_string("scheduler_ip", "127.0.0.1", "scheduler address")
    fl.define_integer("scheduler_port", 8900, "scheduler port")
    fl.define_float("reconnect_backoff", 5.0, "seconds between reconnects")
    return fl


def main(argv=None) -> int:
    fl = make_flags()
    fl.parse(argv)

    async def _run():
        while True:
            labor = Labor(fl.scheduler_ip, fl.scheduler_port)
            try:
                await labor.run()
            except (ConnectionError, OSError, RuntimeError) as e:
                log.warning("labor connection error: %s", e)
            await asyncio.sleep(fl.reconnect_backoff)
            log.info("reconnecting to scheduler...")

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
