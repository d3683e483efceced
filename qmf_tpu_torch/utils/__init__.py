"""Host utilities of the port: copies of qmf_tpu/utils's jax-free modules
(flags, split, checkpoint, logging)."""

from qmf_tpu_torch.utils.logging import log  # noqa: F401
from qmf_tpu_torch.utils.split import split  # noqa: F401
