"""Plot artifacts. Counterpart of ``vision_collision_detection_tpu/obs/
plots.py``: the training curves the ``Trainer`` renders after a run, the
confusion matrix that ``evaluate`` and ``Trainer.test`` render, the
grid-search summary of ``cli/grid_search.py``, an accelerometer trace and a
grid of predictions. matplotlib is imported inside the functions
(headless, Agg)."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_training_curves(history_df, out_path: str) -> str:
    """Loss, accuracy, AUC and learning-rate curves per epoch, one panel
    each where ``history_df`` (a DataFrame of ``TrainingHistory``'s records)
    has the columns; returns ``out_path``."""
    plt = _pyplot()
    panels = [
        ("loss", ["train_loss", "val_loss"]),
        ("accuracy", ["train_accuracy", "val_accuracy"]),
        ("auc", ["val_auc"]),
        ("learning rate", ["learning_rate"]),
    ]
    panels = [(t, [c for c in cols if c in history_df.columns])
              for t, cols in panels]
    panels = [(t, cols) for t, cols in panels if cols]
    fig, axes = plt.subplots(1, len(panels), figsize=(5 * len(panels), 4))
    if len(panels) == 1:
        axes = [axes]
    for ax, (title, cols) in zip(axes, panels):
        for c in cols:
            ax.plot(history_df["epoch"], history_df[c], marker="o", label=c)
        ax.set_title(title)
        ax.set_xlabel("epoch")
        ax.legend()
        ax.grid(alpha=0.3)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_confusion_matrix(cm, class_names: Sequence[str], out_path: str,
                          normalize: bool = False) -> str:
    """Annotated heatmap PNG of ``cm`` (rows true, columns predicted);
    returns ``out_path``."""
    plt = _pyplot()
    cm = np.asarray(cm, dtype=np.float64)
    if normalize:
        cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(5, 4.5))
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(class_names)), class_names, rotation=30,
                  ha="right")
    ax.set_yticks(range(len(class_names)), class_names)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    thresh = cm.max() / 2 if cm.size else 0.5
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            val = f"{cm[i, j]:.2f}" if normalize else f"{int(cm[i, j])}"
            ax.text(j, i, val, ha="center", va="center",
                    color="white" if cm[i, j] > thresh else "black")
    fig.colorbar(im)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_grid_search(results_df, out_path: str,
                     metric: str = "best_val_loss") -> str:
    """A bar per experiment of ``results_df`` (a DataFrame with
    ``experiment`` and ``metric`` columns) and, where it has ``backbone``
    and ``temporal_mode`` columns, a backbone × temporal-mode heatmap of the
    least ``metric``; returns ``out_path``."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(13, 4.5))
    df = results_df.sort_values(metric)
    axes[0].barh(df["experiment"], df[metric], color="#3b6fb5")
    axes[0].set_xlabel(metric)
    axes[0].invert_yaxis()
    axes[0].grid(alpha=0.3, axis="x")

    if {"backbone", "temporal_mode"} <= set(df.columns):
        pivot = df.pivot_table(index="backbone", columns="temporal_mode",
                               values=metric, aggfunc="min")
        im = axes[1].imshow(pivot.values, cmap="viridis_r")
        axes[1].set_xticks(range(len(pivot.columns)), pivot.columns)
        axes[1].set_yticks(range(len(pivot.index)), pivot.index)
        for i in range(pivot.shape[0]):
            for j in range(pivot.shape[1]):
                v = pivot.values[i, j]
                if np.isfinite(v):
                    axes[1].text(j, i, f"{v:.3f}", ha="center", va="center",
                                 color="white")
        fig.colorbar(im, ax=axes[1])
        axes[1].set_title(f"min {metric}")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_acceleration(sensor_df, out_path: str,
                      event_time_sec: Optional[float] = None,
                      time_column: str = "time_sec") -> str:
    """Accelerometer trace of ``sensor_df`` (the DataFrame
    ``media.sensors.read_sensor_csv`` returns): each axis, the total G and
    an optional event marker; returns ``out_path``."""
    plt = _pyplot()
    t = sensor_df[time_column] - sensor_df[time_column].iloc[0]
    fig, ax = plt.subplots(figsize=(9, 4))
    for col, color in (("accel_x_G", "#c44"), ("accel_y_G", "#4a4"),
                       ("accel_z_G", "#47c")):
        if col in sensor_df:
            ax.plot(t, sensor_df[col], label=col, alpha=0.7, color=color)
    if "accel_total_G" in sensor_df:
        ax.plot(t, sensor_df["accel_total_G"], label="accel_total_G",
                color="black", linewidth=1.6)
    if event_time_sec is not None:
        ax.axvline(event_time_sec, color="#d60", linestyle="--",
                   label=f"event @ {event_time_sec:.2f}s")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("acceleration (G)")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_prediction_grid(frames_batch: np.ndarray, results: List[Dict],
                         out_path: str, max_clips: int = 8,
                         frame_index: Optional[int] = None) -> str:
    """One frame per clip (the middle one, or ``frame_index``) of
    ``frames_batch`` [B, T, H, W, 3] under its predicted class and
    confidence, above a bar per class probability; returns ``out_path``."""
    plt = _pyplot()
    n = min(len(results), frames_batch.shape[0], max_clips)
    fig, axes = plt.subplots(2, n, figsize=(2.6 * n, 5.5),
                             gridspec_kw={"height_ratios": [3, 1]})
    if n == 1:
        axes = axes.reshape(2, 1)
    t = frame_index if frame_index is not None else frames_batch.shape[1] // 2
    for i in range(n):
        img = frames_batch[i, t]
        if img.dtype != np.uint8:
            img = np.clip(img * 255, 0, 255).astype(np.uint8)
        axes[0, i].imshow(img)
        axes[0, i].axis("off")
        r = results[i]
        title = r.get("predicted_class", "?")
        conf = r.get("confidence", 0.0)
        axes[0, i].set_title(f"{title}\n{conf * 100:.0f}%", fontsize=9)
        probs = r.get("probabilities", {})
        axes[1, i].bar(range(len(probs)), list(probs.values()),
                       color="#3b6fb5")
        axes[1, i].set_ylim(0, 1)
        axes[1, i].set_xticks(range(len(probs)),
                              [c[:4] for c in probs], fontsize=7)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
