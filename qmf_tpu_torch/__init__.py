"""qmf_tpu_torch — the PyTorch/CUDA port of qmf_tpu.

A second package beside the JAX reference ``qmf_tpu``, with the same module
layout: single-device WALS training, its ranking metrics and the reference
text formats and CLI, in PyTorch. The batched SPD solve of each half-epoch
runs through a hand-written CUDA kernel for Hopper (``csrc/chol_solve.cu``,
built at first use by ``kernels.py``); on CPU tensors its plain PyTorch
version runs instead. Nothing here imports jax: the host layer that is
jax-free in ``qmf_tpu`` (config, data, flags, logging, checkpoint) is shared.

Not ported yet (ROADMAP.md): BPR, top-N serving, multi-device training, the
control plane, the hot/cold build split, on-device packing, and the fused
build+solve kernel.
"""

__version__ = "0.1.0"

from qmf_tpu_torch.config import MetricsConfig, WALSConfig  # noqa: F401
