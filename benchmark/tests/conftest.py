"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests that need a CUDA card carry the ``card`` marker and take the ``card``
fixture, which decides inside the test whether a card exists and skips
where there is none. The others run on the CPU at small sizes:
``tiny_cell`` gives a cell of ``BENCHMARK.json`` cut to such a size (the
configuration's widths too, by its architecture's ``shrink``: these runs
test the harness, not the configuration).
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
    """Cell ``w`` at a size a CPU test run holds: the configuration cut by
    its architecture's ``shrink``, pools of 6 or 8 clips."""
    from benchmark import architectures

    t = w["t"]
    w["c"] = architectures.get(w["c"]["architecture"]).shrink(w["c"])
    if t["kind"] == "serve":
        t.update(clips_per_request=[2, 4], pool_clips=6, max_requests=20,
                 loader_batch=2, traced_requests=2)
    else:
        t.update(pool_clips=8)
    return w


@pytest.fixture
def shrunk():
    """``shrink``, for a cell a test builds itself."""
    return shrink


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
