"""qmf_tpu_torch — the PyTorch/CUDA port of qmf_tpu.

A second package beside the JAX reference ``qmf_tpu``, with the same module
layout: WALS and BPR training, their ranking metrics and the
reference text formats and CLIs, in PyTorch. The batched SPD solve of each half-epoch
runs through a hand-written CUDA kernel for Hopper (``csrc/chol_solve.cu``),
or, with ``solver="fused"``, the normal-equation build and the solve run
together in ``csrc/build_solve.cu``, optionally with the hot/cold split;
``kernels.py`` builds them at first use. ``ops/gather.py`` holds the row
gather as hand-written kernels (``csrc/gather.cu``) with two probe tools,
and ``models/recommend.py`` with ``cli/recommend.py`` serves top-N lists
from trained factors. BPR (``ops/bpr_ops.py``, ``models/bpr.py``,
``cli/bpr.py``) is plain tensor arithmetic, as it is plain ``jnp`` in
``qmf_tpu``, with every random draw an argument. On CPU tensors the kernels'
plain PyTorch versions run instead. Nothing here imports jax or ``qmf_tpu``: the host
layer that is jax-free in ``qmf_tpu`` (config, data, flags, logging,
checkpoint) is copied into ``config.py``, ``data/`` and ``utils/``, with the
same file formats. ``parallel/`` trains both engines over several ranks of
a ``torch.distributed`` group (``ShardedWALSEngine``, ``ShardedBPREngine``),
and ``distributed/`` with the wals_scheduler, wals_labor and wals_submit
CLIs runs that engine from a job queue, one worker process a rank.

Not ported yet (ROADMAP.md): on-device packing.
"""

__version__ = "0.1.0"

from qmf_tpu_torch.config import (  # noqa: F401
    BPRConfig,
    MetricsConfig,
    WALSConfig,
)
