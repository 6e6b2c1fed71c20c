"""The port's spans and the device feed's counters: ``obs/profiling.annotate``
with and without a profiler, the ``vcd.*`` spans of the serving loop and of
a training epoch in a trace written by ``obs/profiling.trace``, and
``device_feed``'s counters (the CUDA path's on the card:
``python -m pytest tests/test_torch_tracing.py -m card --noconftest``, which
leaves out ``tests/conftest.py`` and its JAX import)."""

from __future__ import annotations

import collections
import json
import sys
import threading

import numpy as np
import pytest
import torch

from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.data.loader import (
    ClipLoader,
    device_feed,
)
from vision_collision_detection_tpu_torch.obs import profiling

FEED_COUNTERS = ("feeds", "batches", "next_ns", "stage_ns", "pin_allocs",
                 "pinned_bytes")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda")


class Clips:
    """``n`` uint8 clips [frames, side, side, 3] whose labels cycle over 3
    classes, fetched a batch at a time as ``ClipDataset.get_batch`` hands
    them over."""

    supports_batch = True

    def __init__(self, n: int, frames: int, side: int = 32):
        rng = np.random.default_rng(0)
        self.frames = rng.integers(0, 256, (n, frames, side, side, 3),
                                   dtype=np.uint8)
        self._labels = np.arange(n) % 3

    def __len__(self):
        return len(self.frames)

    def labels(self):
        return self._labels

    def class_weights(self):
        return np.ones(3, np.float32)

    def get_batch(self, idxs, epoch=0, num_threads=0):
        idxs = np.asarray(idxs)
        b, t = len(idxs), self.frames.shape[1]
        return {"frames": self.frames[idxs],
                "sensor": np.zeros((b, t, 4), np.float32),
                "target": self._labels[idxs], "id": [f"clip{i}" for i in idxs],
                "error": np.zeros(b, bool), "pad": np.zeros(b, bool)}


def tiny_config(**over) -> ExperimentConfig:
    return ExperimentConfig().override({
        "model.backbone": "resnet18", "model.temporal_mode": "pooling",
        "model.dtype": "float32", "data.fps": 2, "data.duration": 2,
        "data.frame_size": 32, "data.batch_size": 2, "data.num_workers": 1,
        "train.validation_freq": 0, "train.log_every_steps": 0,
        "train.checkpoint_every_epochs": 0, **over})


def span_counts(trace_dir) -> collections.Counter:
    """The ``vcd.*`` host spans of the trace in ``trace_dir``, by name."""
    with open(trace_dir / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter(
        e["name"] for e in events if e.get("cat") == "user_annotation"
        and e.get("name", "").startswith("vcd."))


def feed_counters() -> dict:
    return {k: getattr(device_feed, k) for k in FEED_COUNTERS}


def test_annotate_is_a_shared_no_op_without_a_profiler(tmp_path):
    off = profiling.annotate("vcd.test.off")
    assert off is profiling.annotate("vcd.test.other")
    with off, off:  # reusable and reentrant
        pass
    with profiling.trace(str(tmp_path)):
        on = profiling.annotate("vcd.test.on")
        assert on is not off
        with on:
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert span_counts(tmp_path) == {"vcd.test.on": 1}


def test_serving_loop_spans(tmp_path):
    """5 clips in batches of 2: three batches, each issued and emitted once,
    and a wait on the feed for each and one for its end. On the CPU there
    is no result copy to wait for."""
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor,
    )

    torch.manual_seed(0)
    pred = CollisionPredictor(tiny_config(), None, device="cpu")
    stride = pred._fold_stride()
    clips = Clips(5, pred.cfg.data.num_frames // stride)
    ids = {f"clip{i}": f"clip{i}.mp4" for i in range(5)}
    pred._predict_batches(ClipLoader(clips, 2), stride, ids)  # warm
    with profiling.trace(str(tmp_path)):
        results = pred._predict_batches(ClipLoader(clips, 2), stride, ids)
    assert [r["id"] for r in results] == list(ids)
    assert span_counts(tmp_path) == {"vcd.serve.forward": 3,
                                     "vcd.serve.emit": 3,
                                     "vcd.feed.wait": 4}


def test_training_epoch_spans(tmp_path):
    """A ``Trainer`` epoch of 3 steps: each step's four phases once, a wait
    on the feed for each batch and one for its end."""
    from vision_collision_detection_tpu_torch.train import Trainer

    cfg = tiny_config()
    clips = Clips(6, cfg.data.num_frames)
    tr = Trainer(cfg, clips, Clips(2, cfg.data.num_frames),
                 run_dir=str(tmp_path / "run"), device="cpu")
    assert tr.steps_per_epoch == 3
    with profiling.trace(str(tmp_path / "prof")):
        tr._train_epoch(0)
    counts = span_counts(tmp_path / "prof")
    assert counts == {"vcd.train.preprocess": 3, "vcd.train.forward": 3,
                      "vcd.train.backward": 3, "vcd.train.optimizer": 3,
                      "vcd.feed.wait": 4}


def test_feed_counts_every_batch_on_the_cpu():
    before = feed_counters()
    got = list(device_feed(iter(ClipLoader(Clips(7, 2), 3)), "cpu"))
    after = feed_counters()
    assert len(got) == 3
    assert after["feeds"] - before["feeds"] == 1
    assert after["batches"] - before["batches"] == 3
    # the CPU path has no producer thread and stages nothing
    for k in ("next_ns", "stage_ns", "pin_allocs", "pinned_bytes"):
        assert after[k] == before[k]


def test_feed_counters_lose_no_update_across_threads():
    """Eight feeds at once on eight threads (more than this host gives the
    test), the interpreter switching threads every microsecond: every
    feed and batch is counted."""
    feeds, per_feed = 8, 200
    batches = [{"frames": np.zeros((1, 1), np.uint8), "sensor": np.zeros(1),
                "target": np.zeros(1)}] * per_feed
    before = feed_counters()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: list(device_feed(iter(batches), "cpu")))
            for _ in range(feeds)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    after = feed_counters()
    assert after["feeds"] - before["feeds"] == feeds
    assert after["batches"] - before["batches"] == feeds * per_feed


@pytest.mark.card
def test_feed_counters_on_the_card(card):
    """The CUDA path: 5 batches of two keys through a ring of 3 slots. The
    producer waits on the loader and stages every batch; it allocates each
    slot's two pinned buffers once, and a second feed allocates its ring
    anew."""
    rng = np.random.default_rng(0)
    batches = [{"frames": rng.integers(0, 256, (2, 4, 16, 16, 3), np.uint8),
                "target": np.arange(2)} for _ in range(5)]
    slot_bytes = batches[0]["frames"].nbytes + batches[0]["target"].nbytes
    for feed in (1, 2):
        before = feed_counters()
        got = list(device_feed(iter(batches), card, depth=2,
                               keys=("frames", "target")))
        torch.cuda.synchronize()
        after = feed_counters()
        delta = {k: after[k] - before[k] for k in FEED_COUNTERS}
        assert len(got) == 5, feed
        np.testing.assert_array_equal(got[4]["frames"].cpu().numpy(),
                                      batches[4]["frames"])
        assert delta["feeds"] == 1 and delta["batches"] == 5
        assert delta["next_ns"] > 0 and delta["stage_ns"] > 0
        assert delta["pin_allocs"] == 3 * 2
        assert delta["pinned_bytes"] == 3 * slot_bytes
