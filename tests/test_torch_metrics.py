"""The port's classification metrics against the JAX package's on seeded
labels and probabilities: AUC with ties, a class absent, one class only."""

import math

import numpy as np
import pytest

from vision_collision_detection_tpu.metrics import classification as jax_metrics
from vision_collision_detection_tpu_torch.metrics import classification as metrics

NAMES = ("Normal", "Near Collision", "Collision")
CASES = ("random", "ties", "class_absent", "one_class", "small")


def _case(name):
    rng = np.random.default_rng(CASES.index(name))
    n, c = 40, 3
    y_true = rng.integers(0, c, n)
    probs = rng.dirichlet(np.ones(c), n)
    if name == "ties":  # scores on a coarse grid: many equal scores
        probs = np.round(probs * 4) / 4
    elif name == "class_absent":
        y_true = np.where(y_true == 1, 2, y_true)
    elif name == "one_class":
        y_true = np.zeros(n, np.int64)
    elif name == "small":
        y_true, probs = y_true[:3], probs[:3]
    y_pred = probs.argmax(-1)
    return y_true, y_pred, probs


def _assert_same(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, np.ndarray)):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64),
                                   rtol=0, atol=1e-6)
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert type(got) is type(want)
        assert got == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", [
    "confusion_matrix", "accuracy", "precision_recall_f1", "binary_roc_auc",
    "weighted_ovr_auc", "classification_metrics"])
def test_metric_matches_jax(fn, case):
    y_true, y_pred, probs = _case(case)
    args = {
        "confusion_matrix": (y_true, y_pred, 3),
        "accuracy": (y_true, y_pred),
        "precision_recall_f1": (y_true, y_pred, 3),
        "binary_roc_auc": ((y_true == 2).astype(int), probs[:, 2]),
        "weighted_ovr_auc": (y_true, probs, 3),
        "classification_metrics": (y_true, y_pred, probs, 3, NAMES),
    }[fn]
    got = getattr(metrics, fn)(*args)
    want = getattr(jax_metrics, fn)(*args)
    _assert_same(got, want)
    if fn == "classification_metrics":
        assert {"f1_collision", "recall_near_collision", "auc",
                "confusion_matrix", "num_samples"} <= set(got)
