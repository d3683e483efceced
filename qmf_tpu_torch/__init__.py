"""qmf_tpu_torch — the PyTorch/CUDA port of qmf_tpu.

A second package beside the JAX reference ``qmf_tpu``, with the same module
layout: single-device WALS training, its ranking metrics and the reference
text formats and CLI, in PyTorch. The batched SPD solve of each half-epoch
runs through a hand-written CUDA kernel for Hopper (``csrc/chol_solve.cu``),
or, with ``solver="fused"``, the normal-equation build and the solve run
together in ``csrc/build_solve.cu``, optionally with the hot/cold split;
``kernels.py`` builds them at first use. ``ops/gather.py`` holds the row
gather as hand-written kernels (``csrc/gather.cu``) with two probe tools,
and ``models/recommend.py`` with ``cli/recommend.py`` serves top-N lists
from trained factors. On CPU tensors the kernels' plain PyTorch versions
run instead. Nothing here imports jax or ``qmf_tpu``: the host
layer that is jax-free in ``qmf_tpu`` (config, data, flags, logging,
checkpoint) is copied into ``config.py``, ``data/`` and ``utils/``, with the
same file formats.

Not ported yet (ROADMAP.md): BPR training, multi-device training, the
control plane and on-device packing.
"""

__version__ = "0.1.0"

from qmf_tpu_torch.config import MetricsConfig, WALSConfig  # noqa: F401
