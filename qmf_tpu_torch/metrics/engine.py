"""MetricsEngine: the metric lists + record/log history.

Mirrors the reference's MetricsEngine (qmf/metrics/MetricsEngine.{h,cpp}):
four metric-name lists (train/test x plain/averaged), ``add*Metric`` returning
False for unknown names, ``computeAndRecord*`` resolving by name from the
manager, and per-(metric, epoch) history with INFO logging
("epoch E: recorded metric test_avg_auc = V", MetricsEngine.cpp:36-44).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from qmf_tpu.config import MetricsConfig
from qmf_tpu_torch.metrics.manager import MetricsManager
from qmf_tpu.utils.logging import log


class MetricsEngine:
    def __init__(self, config: MetricsConfig | None = None, log_metrics: bool = True):
        self.config = config if config is not None else MetricsConfig()
        self._log = log_metrics
        self.train_metrics: List[str] = []
        self.test_metrics: List[str] = []
        self.train_avg_metrics: List[str] = []
        self.test_avg_metrics: List[str] = []
        # metric key -> [(epoch, value)]
        self.metrics_map: Dict[str, List[Tuple[int, float]]] = {}

    # --- registration -------------------------------------------------------
    def _add_metric(self, metrics: List[str], name: str) -> bool:
        if MetricsManager.get().exists(name):
            metrics.append(name)
            return True
        return False

    def add_train_metric(self, name: str) -> bool:
        return self._add_metric(self.train_metrics, name)

    def add_test_metric(self, name: str) -> bool:
        return self._add_metric(self.test_metrics, name)

    def add_train_avg_metric(self, name: str) -> bool:
        return self._add_metric(self.train_avg_metrics, name)

    def add_test_avg_metric(self, name: str) -> bool:
        return self._add_metric(self.test_avg_metrics, name)

    # --- compute + record -----------------------------------------------------
    def _compute_and_record(
        self, metrics: List[str], prefix: str, epoch: int, labels, scores
    ) -> None:
        for name in metrics:
            metric = MetricsManager.get().get_metric(name)
            if metric is None:
                raise KeyError(f"missing metric {prefix}{name}")
            val = metric.compute(labels, scores)
            self.record_metric(prefix + name, epoch, val)

    def compute_and_record_train_metrics(self, epoch, labels, scores):
        """Plain (non-averaged) metrics over flat label/score vectors
        (reference MetricsEngine.h:58-66)."""
        self._compute_and_record(
            self.train_metrics, "train_", epoch, labels, scores
        )

    def compute_and_record_test_metrics(self, epoch, labels, scores):
        self._compute_and_record(
            self.test_metrics, "test_", epoch, labels, scores
        )

    def compute_and_record_train_avg_metrics(self, epoch, labels, scores):
        self._compute_and_record(
            self.train_avg_metrics, "train_avg_", epoch, labels, scores
        )

    def compute_and_record_test_avg_metrics(self, epoch, labels, scores):
        self._compute_and_record(
            self.test_avg_metrics, "test_avg_", epoch, labels, scores
        )

    def record_metric(self, key: str, epoch: int, val: float) -> None:
        self.metrics_map.setdefault(key, []).append((epoch, val))
        if self._log:
            log.info("epoch %d: recorded metric %s = %.10g", epoch, key, val)

    def last(self, key: str) -> Tuple[int, float]:
        return self.metrics_map[key][-1]
