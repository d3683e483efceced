"""Vectorized ranking/regression metrics (MSE, AUC, AP, P@k, R@k) in PyTorch.

Port of qmf_tpu/metrics/metrics.py (reference qmf/metrics/Metrics.cpp):
every metric computes for all test users at once, on the device the scores
lie on, as a two-key order (score descending, positives first on ties,
matching the reference's ``std::greater<pair<Double,bool>>`` comparator)
followed by cumulative sums.

Reference edge-case semantics preserved:
- AUC with an empty class returns 1.0 and logs an error
  (Metrics.cpp:80-84).
- P@k / R@k require at least k ranked elements (Metrics.cpp:104,120).
- R@k / AP require at least one positive (Metrics.cpp:129,151).
"""

from __future__ import annotations

import numpy as np
import torch

from qmf_tpu.utils.logging import log


def _ranked_positives(labels: torch.Tensor,
                      scores: torch.Tensor) -> torch.Tensor:
    """Per-row positive indicators ordered by (score desc, positive first).

    labels/scores: (T, I). Returns (T, I) of 0/1 in ranked order. Two stable
    sorts, secondary key first: positives first, then by score descending,
    which keeps positives ahead among equal scores.
    """
    pos = (labels > 0.0).to(scores.dtype)
    order = torch.sort(pos, dim=-1, descending=True, stable=True).indices
    by_score = torch.sort(
        scores.gather(-1, order), dim=-1, descending=True, stable=True
    ).indices
    return pos.gather(-1, order.gather(-1, by_score))


def mse_batch(labels: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Per-user mean squared error (Metrics.cpp:54-63)."""
    return torch.mean(torch.square(labels - scores), dim=-1)


def auc_batch(labels: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Per-user AUC via ranked true-positive accumulation (Metrics.cpp:65-99).

    Rows where either class is empty yield 1.0 (callers log the error).
    """
    b = _ranked_positives(labels, scores)
    cum = torch.cumsum(b, dim=-1)
    pos = cum[:, -1]
    neg = b.shape[-1] - pos
    # each negative contributes (#positives ranked before it) / (pos*neg)
    auc = torch.sum((1.0 - b) * cum, dim=-1) / torch.clamp(pos * neg, min=1.0)
    return torch.where((pos == 0) | (neg == 0), 1.0, auc)


def precision_at_k_batch(labels: torch.Tensor, scores: torch.Tensor,
                         k: int) -> torch.Tensor:
    """Per-user P@k: positives among the k top-ranked items / k
    (Metrics.cpp:101-117)."""
    b = _ranked_positives(labels, scores)
    return torch.sum(b[:, :k], dim=-1) / k


def recall_at_k_batch(labels: torch.Tensor, scores: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Per-user R@k: positives among top k / total positives
    (Metrics.cpp:119-137)."""
    b = _ranked_positives(labels, scores)
    total_pos = torch.sum(b, dim=-1)
    return torch.sum(b[:, :k], dim=-1) / torch.clamp(total_pos, min=1.0)


def average_precision_batch(labels: torch.Tensor,
                            scores: torch.Tensor) -> torch.Tensor:
    """Per-user AP: mean over positives of precision at their rank
    (Metrics.cpp:139-164)."""
    b = _ranked_positives(labels, scores)
    cum = torch.cumsum(b, dim=-1)
    ranks = torch.arange(1, b.shape[-1] + 1, dtype=cum.dtype,
                         device=cum.device)
    total_pos = cum[:, -1]
    ap = torch.sum(b * cum / ranks, dim=-1)
    return ap / torch.clamp(total_pos, min=1.0)


class Metric:
    """Named metric with the reference's compute-then-average contract.

    ``compute(labels, scores)`` takes (T, I) label/score matrices (the dense
    per-test-user rows built by Engine.init_avg_test_data) and returns the
    mean over users (Metrics.cpp:27-52). Scores may be a tensor on any
    device; the labels follow it there.
    """

    name = "metric"

    def _batch(self, labels: torch.Tensor,
               scores: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _validate(self, labels_np: np.ndarray) -> None:
        pass

    def compute(self, labels, scores) -> float:
        """(T, I) label/score matrices -> mean over users; 1-D inputs are
        treated as a single row (the reference's plain scalar ``compute``
        overload, Metrics.h:30-40)."""
        labels_np = np.asarray(labels)
        if not isinstance(scores, torch.Tensor):
            scores = torch.from_numpy(np.asarray(scores, dtype=np.float64))
        if labels_np.ndim == 1:
            labels_np = labels_np[None, :]
            scores = scores.unsqueeze(0)
        if labels_np.ndim != 2:
            raise ValueError("labels/scores must be (num_users, num_items)")
        if labels_np.shape[0] == 0:
            raise ValueError("need at least one user")
        if tuple(labels_np.shape) != tuple(scores.shape):
            raise ValueError("labels and scores shapes differ")
        self._validate(labels_np)
        labels_t = torch.as_tensor(
            labels_np, dtype=scores.dtype, device=scores.device
        )
        return float(torch.mean(self._batch(labels_t, scores)))


class MeanSquaredError(Metric):
    name = "mse"

    def _batch(self, labels, scores):
        return mse_batch(labels, scores)


class AUC(Metric):
    name = "auc"

    def _validate(self, labels_np):
        pos = (labels_np > 0).sum(axis=1)
        if np.any((pos == 0) | (pos == labels_np.shape[1])):
            # reference logs and returns 1.0 for those rows (Metrics.cpp:80-84)
            log.error("AUC needs at least 1 example in each class")

    def _batch(self, labels, scores):
        return auc_batch(labels, scores)


class AveragePrecision(Metric):
    name = "ap"

    def _validate(self, labels_np):
        if np.any((labels_np > 0).sum(axis=1) == 0):
            raise ValueError("AP needs at least 1 positive")

    def _batch(self, labels, scores):
        return average_precision_batch(labels, scores)


class Precision(Metric):
    def __init__(self, k: int):
        self.k = int(k)
        self.name = f"p@{k}"

    def _validate(self, labels_np):
        if labels_np.shape[1] < self.k:
            raise ValueError("P@k needs at least k ranked elements")

    def _batch(self, labels, scores):
        return precision_at_k_batch(labels, scores, self.k)


class Recall(Metric):
    def __init__(self, k: int):
        self.k = int(k)
        self.name = f"r@{k}"

    def _validate(self, labels_np):
        if labels_np.shape[1] < self.k:
            raise ValueError("R@k needs at least k ranked elements")
        if np.any((labels_np > 0).sum(axis=1) == 0):
            raise ValueError("R@k needs at least 1 positive")

    def _batch(self, labels, scores):
        return recall_at_k_batch(labels, scores, self.k)
