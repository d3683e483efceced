"""The control plane (port of qmf_tpu/distributed): a scheduler daemon with
a job queue, labor agents that attach to it, and a submit client, speaking
qmf_tpu's wire protocol. Each task runs ShardedWALSEngine in fresh worker
subprocesses, one rank each (worker.py)."""

from qmf_tpu_torch.distributed.labor import Labor  # noqa: F401
from qmf_tpu_torch.distributed.scheduler import Scheduler, run_task  # noqa: F401
from qmf_tpu_torch.distributed.submit import (  # noqa: F401
    scheduler_status,
    submit_task_file,
)
from qmf_tpu_torch.distributed.taskdef import (  # noqa: F401
    TaskDef,
    load_taskdef,
    parse_taskdef,
)
