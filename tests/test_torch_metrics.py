"""The port's metrics (qmf_tpu_torch.metrics) against qmf_tpu.metrics.

The cases of tests/test_metrics.py (ties, empty classes, at-k guards,
multi-user averages, randomized tied scores) go through both in float64 and
agree to 1e-12; the reference's error cases raise in both.
"""

import numpy as np
import pytest
import torch

import qmf_tpu.metrics as jm
import qmf_tpu_torch.metrics as tm
from qmf_tpu.config import MetricsConfig

torch.set_num_threads(1)

METRICS = ["mse", "auc", "ap", "p@1", "p@2", "p@3", "r@2", "r@3", "r@5"]


def _get(mod, name):
    return mod.MetricsManager.get().get_metric(name)


def _random_case(seed):
    rng = np.random.default_rng(seed)
    labels = (rng.random((7, 30)) < 0.3) * rng.integers(1, 5, (7, 30)) * 1.0
    labels[:, 0], labels[:, 1] = 1.0, 0.0
    return labels, np.round(rng.normal(size=(7, 30)), 1)  # tied scores


CASES = {
    "perfect": ([[1.0, 1.0, 0.0, 0.0, 0.0]], [[5.0, 4.0, 3.0, 2.0, 1.0]]),
    "inverted": ([[1.0, 1.0, 0.0, 0.0, 0.0]], [[1.0, 2.0, 3.0, 4.0, 5.0]]),
    "mixed": ([[1.0, 0.0, 1.0, 0.0, 0.0]], [[3.0, 1.0, 2.0, 0.5, 0.1]]),
    "tie_favors_positive": ([[0.0, 1.0, 0.0, 0.0, 0.0]],
                            [[2.0, 2.0, 1.0, 1.0, 0.0]]),
    "multi_user": ([[1.0, 0.0, 0.0, 0.0, 1.0], [0.0, 1.0, 1.0, 0.0, 0.0]],
                   [[2.0, 1.0, 0.0, 0.0, 0.5], [2.0, 1.0, 1.0, 1.0, 3.0]]),
    "flat_vector": ([1.0, 0.0, 1.0, 0.0, 0.0], [0.1, 0.4, 0.3, 0.2, 0.0]),
    **{f"random{s}": _random_case(s) for s in range(3)},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_metrics_match_jax(case):
    labels, scores = (np.asarray(v, dtype=np.float64) for v in CASES[case])
    for name in METRICS:
        got = _get(tm, name).compute(labels, torch.from_numpy(scores))
        want = _get(jm, name).compute(labels, scores)
        assert got == pytest.approx(want, abs=1e-12), name


@pytest.mark.parametrize("labels", [[[1.0, 1.0]], [[0.0, 0.0]]])
def test_auc_empty_class_returns_one(labels):
    for mod in (tm, jm):
        assert mod.AUC().compute(labels, [[0.5, 0.2]]) == 1.0


@pytest.mark.parametrize(
    "metric,labels",
    [
        ("p@5", [[1.0, 0.0]]),
        ("r@5", [[1.0, 0.0]]),
        ("r@1", [[0.0, 0.0]]),
        ("ap", [[0.0, 0.0]]),
    ],
)
def test_at_k_and_positive_guards_raise(metric, labels):
    for mod in (tm, jm):
        with pytest.raises(ValueError):
            _get(mod, metric).compute(labels, [[1.0, 2.0]])


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        tm.AUC().compute([[1.0, 0.0]], torch.zeros(1, 3))


def test_metrics_engine_records_like_jax():
    labels = [[1.0, 0.0], [0.0, 1.0]]
    scores = np.array([[2.0, 1.0], [1.0, 2.0]])
    maps = []
    for mod, sc in ((tm, torch.from_numpy(scores)), (jm, scores)):
        me = mod.MetricsEngine(MetricsConfig(always_compute=True))
        assert me.add_test_avg_metric("auc") and me.add_test_avg_metric("p@1")
        assert not me.add_test_avg_metric("nope")
        me.compute_and_record_test_avg_metrics(3, labels, sc)
        maps.append(me.metrics_map)
    assert maps[0] == maps[1]
    assert maps[0]["test_avg_auc"] == [(3, 1.0)]
