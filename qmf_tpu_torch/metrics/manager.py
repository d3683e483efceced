"""Name -> metric registry with lazy ``p@k`` / ``r@k`` construction.

Mirrors the reference's MetricsManager singleton
(qmf/metrics/MetricsManager.cpp): pre-registers ``mse``/``auc``/``ap`` and
lazily parses at-k names on lookup (``parseAtKMetric``,
MetricsManager.cpp:41-55).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from qmf_tpu_torch.metrics.metrics import (
    AUC,
    AveragePrecision,
    MeanSquaredError,
    Metric,
    Precision,
    Recall,
)


def parse_at_k_metric(name: str) -> Optional[Tuple[str, int]]:
    """Parse names like ``p@5`` -> ("p", 5); None if not an at-k name."""
    pos = name.find("@")
    if pos <= 0:
        return None
    try:
        k = int(name[pos + 1 :])
    except ValueError:
        return None
    if k < 0:
        return None
    return name[:pos], k


class MetricsManager:
    _instance: Optional["MetricsManager"] = None

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self.register(MeanSquaredError())
        self.register(AUC())
        self.register(AveragePrecision())

    def register(self, metric: Metric) -> None:
        self._metrics[metric.name] = metric

    def _init_from_name(self, name: str) -> bool:
        parsed = parse_at_k_metric(name)
        if parsed is None:
            return False
        base, k = parsed
        if base == "p":
            self.register(Precision(k))
        elif base == "r":
            self.register(Recall(k))
        else:
            return False
        return True

    def exists(self, name: str) -> bool:
        return name in self._metrics or self._init_from_name(name)

    def get_metric(self, name: str) -> Optional[Metric]:
        if self.exists(name):
            return self._metrics[name]
        return None

    @classmethod
    def get(cls) -> "MetricsManager":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance
