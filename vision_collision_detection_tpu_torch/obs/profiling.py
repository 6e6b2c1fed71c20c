"""Profiling helpers: ``torch.profiler`` traces and throughput counters.

Counterpart of ``vision_collision_detection_tpu/obs/profiling.py``:

- ``trace(dir)``: captures the host's and the card's activity (CPU and,
  where a card exists, CUDA) and writes it to ``dir`` as a Chrome trace
  (``trace.json``, opened by Perfetto or ``chrome://tracing``);
- ``annotate(name)``: a named span (``torch.profiler.record_function``)
  for host-side phases;
- ``StepTimer``: steady-state steps/s and items/s with warm-up steps
  left out, plus percentiles.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profile: ``with trace('runs/prof'): step(...)``; the trace
    lands in ``log_dir/trace.json`` when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A host-side span, named ``name`` in the trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Throughput counter with warm-up steps left out.

    >>> t = StepTimer(warmup_steps=2, items_per_step=batch_size)
    >>> for batch in loader:
    ...     with t.step():
    ...         train_step(...)
    >>> t.summary()  # {'steps', 'mean_ms', 'p50_ms', 'p95_ms', ...}

    A step's time is the host's: to time the card's work, synchronise
    inside the step.
    """

    def __init__(self, warmup_steps: int = 1, items_per_step: int = 1):
        self.warmup_steps = warmup_steps
        self.items_per_step = items_per_step
        self.durations: List[float] = []
        self._seen = 0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.warmup_steps:
            self.durations.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self.durations:
            return {"steps": 0}
        d = np.asarray(self.durations)
        return {
            "steps": len(d),
            "mean_ms": float(d.mean() * 1000),
            "p50_ms": float(np.percentile(d, 50) * 1000),
            "p95_ms": float(np.percentile(d, 95) * 1000),
            "steps_per_sec": float(1.0 / d.mean()),
            "items_per_sec": float(self.items_per_step / d.mean()),
        }
