"""Multi-device training (port of qmf_tpu/parallel): one process per rank,
``torch.distributed`` among them (NCCL for CUDA tensors, gloo on the CPU).
``launch.spawn`` starts local ranks; ``multihost.initialize`` joins ranks
started elsewhere (torchrun)."""

from qmf_tpu_torch.parallel.engine import ShardedWALSEngine  # noqa: F401
from qmf_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from qmf_tpu_torch.parallel.sharded_wals import (  # noqa: F401
    ShardedBuckets,
    iterate_side_sharded,
    pad_rows,
    sharded_gramian,
)
from qmf_tpu_torch.parallel.sharded_bpr import ShardedBPREngine  # noqa: F401
from qmf_tpu_torch.parallel import multihost  # noqa: F401
