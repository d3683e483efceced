"""Submit client: send a task file to the scheduler and await the ack (the
port's counterpart of qmf_tpu/distributed/submit.py).

Re-design of reference wals_submit (reference qmf/wals_submit.cpp:27-91).
Improvement over the reference: the task file CONTENT is sent, not its path,
dropping the shared-filesystem assumption (Connection.cpp:152-156); a
``send_path=True`` mode preserves the reference behavior.
"""

from __future__ import annotations

from typing import Any, Dict

from qmf_tpu_torch.distributed import protocol
from qmf_tpu_torch.distributed.taskdef import parse_taskdef


def submit_task_file(
    host: str, port: int, task_file: str, send_path: bool = False
) -> Dict[str, Any]:
    if send_path:
        msg = {"kind": "submit_task", "task_path": task_file}
    else:
        with open(task_file) as f:
            text = f.read()
        parse_taskdef(text)  # fail fast client-side on malformed files
        msg = {"kind": "submit_task", "task_text": text}
    return protocol.send_and_recv(host, port, msg)


def scheduler_status(host: str, port: int) -> Dict[str, Any]:
    return protocol.send_and_recv(host, port, {"kind": "status"})
