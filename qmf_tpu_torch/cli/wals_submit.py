"""``wals_submit`` CLI of the PyTorch port (reference qmf/wals_submit.cpp;
qmf_tpu/cli/wals_submit.py).

Usage (positional, like the reference):
    python -m qmf_tpu_torch.cli.wals_submit <scheduler_ip> <port> <task_file>
    python -m qmf_tpu_torch.cli.wals_submit --status <scheduler_ip> <port>

By default the task file content is sent (no shared-filesystem assumption);
``--send_path`` restores the reference's path-based submission.
"""

from __future__ import annotations

import json
import signal
import sys

from qmf_tpu_torch.distributed.submit import scheduler_status, submit_task_file
from qmf_tpu_torch.utils.flags import Flags
from qmf_tpu_torch.utils.logging import log


def make_flags() -> Flags:
    fl = Flags(
        "wals_submit <scheduler_ip> <scheduler_port> <task_file>"
    )
    fl.define_bool("send_path", False, "send the file path, not its content")
    fl.define_bool("status", False, "query scheduler status instead")
    return fl


def main(argv=None) -> int:
    # behave like a unix tool when piped into head etc.
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    fl = make_flags()
    pos = fl.parse(argv)

    if fl.status:
        if len(pos) < 2:
            fl.print_help()
            return 2
        print(json.dumps(scheduler_status(pos[0], int(pos[1])), indent=2))
        return 0

    if len(pos) < 3:
        fl.print_help()
        return 2
    host, port, task_file = pos[0], int(pos[1]), pos[2]
    rsp = submit_task_file(host, port, task_file, send_path=fl.send_path)
    if rsp.get("status") == "OK":
        log.info("task submitted OK, taskid=%s", rsp.get("taskid"))
        return 0
    log.error("submit failed: %s", rsp)
    return 1


if __name__ == "__main__":
    sys.exit(main())
