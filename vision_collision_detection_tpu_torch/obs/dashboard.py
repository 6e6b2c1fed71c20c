"""Live training dashboard.

Counterpart of ``vision_collision_detection_tpu/obs/dashboard.py``: the
reference's ``DynamicTrainingVisualizer`` API (``start_epoch`` /
``update_train_loss`` / ``update_val_metrics`` /
``update_full_val_metrics`` / ``mark_epoch``; a moving-average loss window
of 29; progress, ETA and it/s) and its distributed-aware factory (the main
process renders, every other process gets a no-op object).

Rendered headless: an ANSI console line and an auto-refreshing HTML file
under the run directory (``dashboard.html``); no Jupyter is needed.
"""

from __future__ import annotations

import collections
import html
import os
import time
from typing import Dict, List, Optional

import numpy as np

from vision_collision_detection_tpu_torch.obs.logging_utils import is_main_process


class _NoOpVisualizer:
    """Absorbs every call on the processes that are not the main one."""

    def __getattr__(self, name):
        def _noop(*a, **k):
            return None

        return _noop


class TrainingVisualizer:
    MA_WINDOW = 29  # moving-average window of the training loss

    def __init__(self, total_epochs: int, steps_per_epoch: int,
                 run_dir: Optional[str] = None, console: bool = True):
        self.total_epochs = total_epochs
        self.steps_per_epoch = steps_per_epoch
        self.run_dir = run_dir
        self.console = console
        self.losses = collections.deque(maxlen=self.MA_WINDOW)
        self.epoch = 0
        self.step = 0
        self.epoch_start = time.time()
        self.run_start = time.time()
        self.mini_val: Dict = {}
        self.full_val: Dict = {}
        self.best_val_loss = float("inf")
        self.epoch_rows: List[Dict] = []

    # ---- reference API ----
    def start_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.step = 0
        self.epoch_start = time.time()

    def update_train_loss(self, loss: float, step: Optional[int] = None) -> None:
        self.losses.append(float(loss))
        self.step = step if step is not None else self.step + 1
        self._render()

    def update_val_metrics(self, metrics: Dict) -> None:  # mini-validation
        self.mini_val = dict(metrics)
        self._render()

    def update_full_val_metrics(self, metrics: Dict) -> None:
        self.full_val = dict(metrics)
        if metrics.get("loss", float("inf")) < self.best_val_loss:
            self.best_val_loss = metrics["loss"]
        self._render()

    def mark_epoch(self, epoch: int, train_metrics: Dict,
                   val_metrics: Optional[Dict] = None) -> None:
        row = {"epoch": epoch, **{f"train_{k}": v
                                  for k, v in train_metrics.items()}}
        if val_metrics:
            row.update({f"val_{k}": v for k, v in val_metrics.items()
                        if np.isscalar(v)})
        self.epoch_rows.append(row)
        self._render(force=True)

    # ---- rendering ----
    def _stats(self) -> Dict:
        elapsed = time.time() - self.epoch_start
        its = self.step / elapsed if elapsed > 0 else 0.0
        remaining = (self.steps_per_epoch - self.step) / its if its > 0 else 0.0
        return {
            "ma_loss": float(np.mean(self.losses)) if self.losses else float("nan"),
            "its_per_sec": its,
            "eta_sec": remaining,
            "progress": self.step / max(self.steps_per_epoch, 1),
        }

    def _render(self, force: bool = False) -> None:
        if not force and self.step % 10 != 0:
            return
        s = self._stats()
        if self.console:
            bar_w = 30
            filled = int(s["progress"] * bar_w)
            bar = "█" * filled + "░" * (bar_w - filled)
            line = (
                f"\r[epoch {self.epoch + 1}/{self.total_epochs}] {bar} "
                f"{self.step}/{self.steps_per_epoch} "
                f"loss(ma) {s['ma_loss']:.4f} {s['its_per_sec']:.2f} it/s "
                f"eta {s['eta_sec']:.0f}s best_val "
                f"{self.best_val_loss if np.isfinite(self.best_val_loss) else float('nan'):.4f}"
            )
            print(line, end="", flush=True)
            if force:
                print()
        if self.run_dir:
            self._write_html(s)

    def _write_html(self, s: Dict) -> None:
        rows = "".join(
            "<tr>" + "".join(
                f"<td>{html.escape(str(round(v, 4) if isinstance(v, float) else v))}</td>"
                for v in row.values()
            ) + "</tr>"
            for row in self.epoch_rows[-20:]
        )
        header = ""
        if self.epoch_rows:
            header = "<tr>" + "".join(
                f"<th>{html.escape(k)}</th>" for k in self.epoch_rows[-1]
            ) + "</tr>"
        doc = f"""<html><head><meta http-equiv="refresh" content="5">
<style>body{{font-family:monospace;background:#111;color:#eee;padding:16px}}
table{{border-collapse:collapse}}td,th{{border:1px solid #444;padding:4px 8px}}
.bar{{background:#333;width:420px;height:14px}}.fill{{background:#4c8dd6;height:14px}}
</style></head><body>
<h3>epoch {self.epoch + 1}/{self.total_epochs} — step {self.step}/{self.steps_per_epoch}</h3>
<div class="bar"><div class="fill" style="width:{s['progress'] * 100:.1f}%"></div></div>
<p>loss (ma{self.MA_WINDOW}): {s['ma_loss']:.4f} · {s['its_per_sec']:.2f} it/s ·
eta {s['eta_sec']:.0f}s · best val loss {self.best_val_loss:.4f}</p>
<p>mini-val: {html.escape(str({k: round(v, 4) for k, v in self.mini_val.items() if np.isscalar(v)}))}</p>
<p>full-val: {html.escape(str({k: round(v, 4) for k, v in self.full_val.items() if np.isscalar(v)}))}</p>
<table>{header}{rows}</table>
</body></html>"""
        try:
            with open(os.path.join(self.run_dir, "dashboard.html"), "w") as f:
                f.write(doc)
        except OSError:
            pass


def create_distributed_visualizer(total_epochs: int, steps_per_epoch: int,
                                  run_dir: Optional[str] = None,
                                  console: bool = True):
    """The main process gets the real visualizer, every other one a
    no-op."""
    if is_main_process():
        return TrainingVisualizer(total_epochs, steps_per_epoch, run_dir,
                                  console)
    return _NoOpVisualizer()
