"""Training history with the reference's flat per-class CSV layout.

Counterpart of ``vision_collision_detection_tpu/obs/history.py``: the flat
per-epoch records, ``training_history.csv``, the per-epoch validation JSON
and ``test_predictions.csv``. The CSV files are written with the standard
``csv`` module in pandas' ``to_csv(index=False)`` layout (the union of the
records' keys as columns in order of first appearance, a missing value or
NaN as an empty field, numpy float32 in its shortest form), so they need no
pandas; ``to_dataframe`` imports pandas inside the function.
"""

from __future__ import annotations

import csv
import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


class TrainingHistory:
    def __init__(self, class_names):
        self.class_names = [
            str(c).lower().replace(" ", "_") for c in class_names
        ]
        self.records: List[Dict] = []

    def append_epoch(self, epoch: int, train_metrics: Dict,
                     val_metrics: Optional[Dict] = None,
                     lr: Optional[float] = None,
                     epoch_time_sec: Optional[float] = None) -> None:
        row: Dict = {"epoch": epoch}
        for k, v in train_metrics.items():
            row[f"train_{k}"] = _scalar(v)
        if val_metrics:
            for k in ("loss", "accuracy", "auc", "weighted_precision",
                      "weighted_recall", "weighted_f1"):
                if k in val_metrics:
                    row[f"val_{k}"] = _scalar(val_metrics[k])
            for cname in self.class_names:
                for m in ("precision", "recall", "f1"):
                    key = f"{m}_{cname}"
                    if key in val_metrics:
                        row[f"val_{key}"] = _scalar(val_metrics[key])
        if lr is not None:
            row["learning_rate"] = float(lr)
        if epoch_time_sec is not None:
            row["epoch_time_sec"] = float(epoch_time_sec)
        self.records.append(row)

    def to_dataframe(self):
        import pandas as pd

        return pd.DataFrame(self.records)

    def save_csv(self, path: str) -> None:
        _write_csv(path, self.records)

    def to_list(self) -> List[Dict]:
        return list(self.records)

    @classmethod
    def from_list(cls, class_names, records) -> "TrainingHistory":
        h = cls(class_names)
        h.records = [dict(r) for r in records]
        return h


def save_metrics_json(path: str, metrics: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({k: _scalar(v) if np.isscalar(v) or isinstance(
            v, (np.generic, float, int)) else v for k, v in metrics.items()},
            f, indent=2, default=str)


def save_predictions_csv(path: str, ids, targets, preds, probs,
                         class_names: Sequence[str]) -> None:
    """Per-clip predictions with per-class probabilities: columns ``id``,
    ``target``, ``predicted``, ``prob_<class>`` and ``correct``."""
    targets, preds = np.asarray(targets), np.asarray(preds)
    probs = np.asarray(probs)
    names = [f"prob_{str(n).lower().replace(' ', '_')}" for n in class_names]
    rows = []
    for i, vid in enumerate(ids):
        row = {"id": vid, "target": targets[i], "predicted": preds[i]}
        row.update(zip(names, probs[i]))
        row["correct"] = bool(targets[i] == preds[i])
        rows.append(row)
    _write_csv(path, rows,
               ["id", "target", "predicted", *names, "correct"])


def _write_csv(path: str, records: Sequence[Dict],
               columns: Optional[List[str]] = None) -> None:
    """``records`` as pandas' ``DataFrame(records).to_csv(path,
    index=False)`` writes them."""
    if columns is None:
        columns = list(dict.fromkeys(k for r in records for k in r))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for r in records:
            w.writerow([_field(r.get(c)) for c in columns])


def _field(v) -> str:
    """One CSV field as pandas writes it: float64 as ``repr``, numpy
    float32 in its shortest form, a missing value or NaN empty."""
    if v is None:
        return ""
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else (
            repr(float(v)) if isinstance(v, (float, np.float64)) else str(v))
    if isinstance(v, np.generic):
        v = v.item()
    return str(v)


def _scalar(v):
    if isinstance(v, (np.generic,)):
        return v.item()
    if hasattr(v, "item") and getattr(v, "size", 2) == 1:
        return float(v.item())
    return v
