from qmf_tpu_torch.models.bpr import BPREngine  # noqa: F401
from qmf_tpu_torch.models.engine import Engine  # noqa: F401
from qmf_tpu_torch.models.wals import WALSEngine  # noqa: F401
