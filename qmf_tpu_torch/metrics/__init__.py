from qmf_tpu_torch.metrics.engine import MetricsEngine  # noqa: F401
from qmf_tpu_torch.metrics.manager import MetricsManager, parse_at_k_metric  # noqa: F401
from qmf_tpu_torch.metrics.metrics import (  # noqa: F401
    AUC,
    AveragePrecision,
    MeanSquaredError,
    Metric,
    Precision,
    Recall,
)
