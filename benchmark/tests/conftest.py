"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests that need a CUDA card carry the ``card`` marker and take the ``card``
fixture, which decides inside the test whether a card exists and skips
where there is none. The others run on the CPU at small sizes:
``tiny_cell`` gives a cell of ``BENCHMARK.json`` cut to such a size (the
configuration's widths too: these runs test the harness, not the
configuration).
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return "cuda"


def shrink(w: dict) -> dict:
    """Cell ``w`` at a size a CPU test run holds: 32² frames for the
    flagship (12 frames, folded to 6), vivit_tiny's widths at 28² (4
    tokens, 4 frames), B = 2, pools of 6 or 8 clips."""
    c, t = w["c"], w["t"]
    if c["architecture"] == "convnext_gru":
        c.update(frames=12, frame_size=32, content=[18, 32], batch_size=2)
        c["program"] = {"data.fps": 4, "data.duration": 3,
                        "data.frame_size": 32, "data.batch_size": 2}
    else:
        c.update(frames=4, frame_size=28, content=[16, 28], batch_size=2,
                 dim=64, heads=4, mlp_dim=256, spatial_layers=2,
                 temporal_layers=1)
        c["program"] = dict(c["program"], **{
            "model.backbone": "vivit_tiny", "data.fps": 4,
            "data.duration": 1, "data.frame_size": 28,
            "data.batch_size": 2})
    if t["kind"] == "serve":
        t.update(clips_per_request=[2, 4], pool_clips=6, max_requests=20,
                 loader_batch=2, traced_requests=2)
    else:
        t.update(pool_clips=8)
    return w


TRAFFIC = {"serve": "serve_closed", "train": "train_epochs"}


@pytest.fixture
def tiny_cell():
    """``<config>.<serve|train>`` → that configuration under that kind of
    traffic, cut by ``shrink``: a cell of ``BENCHMARK.json`` or one it
    does not hold yet (the drivers run every configuration either way)."""
    from benchmark import harness

    def make(name: str) -> dict:
        config, kind = name.split(".")
        w = {"name": name, "config": config, "traffic": TRAFFIC[kind],
             "chips": 1}
        w["c"] = harness.load_json(harness.HERE / "configs" / f"{config}.json")
        w["t"] = harness.load_json(harness.HERE / "traffic" / f"{TRAFFIC[kind]}.json")
        return shrink(w)

    return make
