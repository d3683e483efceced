"""Host utilities of the port: copies of qmf_tpu/utils's jax-free modules
(flags, split, checkpoint, logging), and tracing.py, the counterpart of
qmf_tpu/utils/tracing.py on torch.profiler."""

from qmf_tpu_torch.utils.logging import log  # noqa: F401
from qmf_tpu_torch.utils.split import split  # noqa: F401
from qmf_tpu_torch.utils.tracing import StepTimer, annotate, trace  # noqa: F401
