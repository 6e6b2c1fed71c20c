"""Classification metrics in numpy: accuracy, per-class precision, recall
and F1, the confusion matrix and the support-weighted one-vs-rest ROC AUC.

The port's own copy of ``vision_collision_detection_tpu/metrics/
classification.py``: the same functions, key names and tie handling, so a
labelled set scores the same in both packages. They run on the host over
gathered outputs.
"""

from __future__ import annotations

import numpy as np


def confusion_matrix(y_true, y_pred, num_classes: int) -> np.ndarray:
    """[num_classes, num_classes] matrix; rows = true, cols = predicted."""
    y_true = np.asarray(y_true, dtype=np.int64)
    y_pred = np.asarray(y_pred, dtype=np.int64)
    idx = y_true * num_classes + y_pred
    cm = np.bincount(idx, minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes)


def accuracy(y_true, y_pred) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_true.size == 0:
        return 0.0
    return float((y_true == y_pred).mean())


def precision_recall_f1(y_true, y_pred, num_classes: int) -> dict:
    """Per-class and weighted precision/recall/F1 (zero_division=0 semantics)."""
    cm = confusion_matrix(y_true, y_pred, num_classes)
    tp = np.diag(cm).astype(np.float64)
    pred_pos = cm.sum(axis=0).astype(np.float64)
    true_pos = cm.sum(axis=1).astype(np.float64)  # support

    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_pos > 0, tp / pred_pos, 0.0)
        recall = np.where(true_pos > 0, tp / true_pos, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)

    support = true_pos
    total = support.sum()
    weights = support / total if total > 0 else np.zeros_like(support)
    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "support": support.astype(np.int64),
        "weighted_precision": float((precision * weights).sum()),
        "weighted_recall": float((recall * weights).sum()),
        "weighted_f1": float((f1 * weights).sum()),
        "macro_precision": float(precision.mean()),
        "macro_recall": float(recall.mean()),
        "macro_f1": float(f1.mean()),
    }


def binary_roc_auc(y_true, y_score) -> float:
    """AUC via the Mann-Whitney U rank statistic with midrank tie handling.

    Equivalent to trapezoidal ROC integration; matches sklearn to float64
    precision. Returns nan when only one class is present.
    """
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = float(y_true.sum())
    n_neg = float(len(y_true) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    sorted_scores = y_score[order]
    # midranks (1-based), averaging over ties
    ranks = np.empty(len(y_score), dtype=np.float64)
    i = 0
    n = len(sorted_scores)
    while i < n:
        j = i
        while j + 1 < n and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[i : j + 1] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_of = np.empty(n, dtype=np.float64)
    rank_of[order] = ranks
    rank_sum_pos = rank_of[y_true == 1].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def weighted_ovr_auc(y_true, probs, num_classes: int | None = None) -> float:
    """One-vs-rest AUC per class, weighted by class support.

    Mirrors ``roc_auc_score(y_true_binarized, probs, multi_class='ovr',
    average='weighted')``, the reference's AUC. Classes absent from y_true
    are skipped (their weight is zero anyway).
    """
    y_true = np.asarray(y_true, dtype=np.int64)
    probs = np.asarray(probs, dtype=np.float64)
    if num_classes is None:
        num_classes = probs.shape[1]
    aucs = np.zeros(num_classes)
    support = np.zeros(num_classes)
    for c in range(num_classes):
        mask_pos = (y_true == c).astype(np.float64)
        support[c] = mask_pos.sum()
        if 0 < support[c] < len(y_true):
            aucs[c] = binary_roc_auc(mask_pos, probs[:, c])
    total = support.sum()
    if total == 0 or np.all(support == 0):
        return float("nan")
    weights = support / total
    valid = (support > 0) & (support < len(y_true))
    if not valid.any():
        return float("nan")
    return float((aucs[valid] * weights[valid]).sum() / weights[valid].sum())


def classification_metrics(
    y_true, y_pred, probs=None, num_classes: int | None = None, class_names=None
) -> dict:
    """Full metric dict in the flat per-class layout of the reference's
    history CSV (``precision_<class>``, ``f1_<class>``, ..., ``auc``)."""
    y_true = np.asarray(y_true, dtype=np.int64)
    y_pred = np.asarray(y_pred, dtype=np.int64)
    if num_classes is None:
        num_classes = int(max(y_true.max(initial=0), y_pred.max(initial=0))) + 1
    if class_names is None:
        class_names = [f"class_{i}" for i in range(num_classes)]

    prf = precision_recall_f1(y_true, y_pred, num_classes)
    out = {
        "accuracy": accuracy(y_true, y_pred),
        "weighted_precision": prf["weighted_precision"],
        "weighted_recall": prf["weighted_recall"],
        "weighted_f1": prf["weighted_f1"],
        "macro_f1": prf["macro_f1"],
        "confusion_matrix": confusion_matrix(y_true, y_pred, num_classes).tolist(),
        "num_samples": int(len(y_true)),
    }
    for i, name in enumerate(class_names):
        slug = str(name).lower().replace(" ", "_")
        out[f"precision_{slug}"] = float(prf["precision"][i])
        out[f"recall_{slug}"] = float(prf["recall"][i])
        out[f"f1_{slug}"] = float(prf["f1"][i])
        out[f"support_{slug}"] = int(prf["support"][i])
    if probs is not None:
        out["auc"] = weighted_ovr_auc(y_true, probs, num_classes)
    return out
