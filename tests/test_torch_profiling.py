"""``obs/profiling.py`` of the port against the JAX package's: ``StepTimer``
on the same mocked clock, and a ``torch.profiler`` trace that holds an
``annotate`` span."""

import json

import pytest
import torch

from vision_collision_detection_tpu.obs import profiling as jax_profiling
from vision_collision_detection_tpu_torch.obs import profiling


def _timed(module, monkeypatch, durations, warmup, items):
    """A ``StepTimer`` of ``module`` over steps of the given durations (s),
    read from a mocked ``time.perf_counter``."""
    ticks = iter([t for i, d in enumerate(durations)
                  for t in (10.0 * i, 10.0 * i + d)])
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks))
    timer = module.StepTimer(warmup_steps=warmup, items_per_step=items)
    for _ in durations:
        with timer.step():
            pass
    return timer.summary()


@pytest.mark.parametrize("durations,warmup,items", [
    ([0.2, 0.2, 0.021, 0.019, 0.025, 0.02], 2, 4),
    ([0.5, 0.01, 0.03, 0.02, 0.04, 0.05, 0.015], 1, 8),
    ([0.3], 1, 1),
])
def test_step_timer_matches_jax(monkeypatch, durations, warmup, items):
    got = _timed(profiling, monkeypatch, durations, warmup, items)
    want = _timed(jax_profiling, monkeypatch, durations, warmup, items)
    assert got == want
    assert got["steps"] == max(len(durations) - warmup, 0)


def test_trace_holds_the_annotated_span(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("vcd-test-span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof" / profiling.TRACE_FILE).read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    assert "vcd-test-span" in names
    assert any(n and "mm" in n for n in names)
