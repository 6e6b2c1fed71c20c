"""The port's ``Trainer``'s content-box guard on synthetic MP4s, after the
JAX package's ``tests/test_content_box.py``: mixed aspects turn it off,
one aspect turns it on, a failed probe is logged, and the port's repair —
every record is probed (the JAX trainer probes 8 a dataset), and a record
that cannot be probed has no say."""

import logging
import os
import shutil
import types

import numpy as np
import pandas as pd
import pytest

from torch_port_helpers import two_torch_threads  # noqa: F401
from vision_collision_detection_tpu.train.trainer import Trainer as JaxTrainer
from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.data import (
    ClipRecord,
    create_datasets_with_manual_split,
)
from vision_collision_detection_tpu_torch.media import decoder
from vision_collision_detection_tpu_torch.train import Trainer


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _aspect_splits(tmp_path, shapes, splits):
    rng = np.random.default_rng(5)
    rows = []
    for i, ((h, w), split) in enumerate(zip(shapes, splits)):
        p = str(tmp_path / f"v{i}.mp4")
        decoder.encode_video(
            p, (rng.random((8, h, w, 3)) * 255).astype(np.uint8), fps=4.0)
        rows.append({"id": f"v{i}", "video_path": p,
                     "video_type": ["Normal", "Collision"][i % 2],
                     "split": split, "sensor_path": ""})
    return create_datasets_with_manual_split(
        pd.DataFrame(rows), class_names=("Normal", "Collision"), fps=4,
        duration=1, frame_size=32)


def _box_config():
    return ExperimentConfig().override({
        "model.dtype": "float32", "data.frame_size": 32,
        "train.validation_freq": 0, "train.log_every_steps": 0,
        "augment.blur_sigma": 0.0,
        "model.num_classes": 2, "data.num_classes": 2,
        "data.class_names": ("Normal", "Collision"), "data.fps": 4,
        "data.duration": 1, "data.batch_size": 2,
        "data.content_box_transfer": True, "train.epochs": 1,
        "augment.enabled": False, "augment.horizontal_flip_prob": 0.0})


def test_content_box_disabled_on_mixed_aspect(tmp_path):
    train, val, test = _aspect_splits(
        tmp_path, [(120, 160), (90, 160), (120, 160), (120, 160)],
        ["train", "train", "val", "test"])
    Trainer(_box_config(), train, val, test, run_dir=str(tmp_path / "run"),
            device="cpu")
    assert train.content_box is None
    assert val.content_box is None and test.content_box is None


def test_content_box_enabled_on_uniform_aspect(tmp_path):
    train, val, test = _aspect_splits(
        tmp_path, [(120, 160)] * 4, ["train", "train", "val", "test"])
    Trainer(_box_config(), train, val, test, run_dir=str(tmp_path / "run"),
            device="cpu")
    # 120x160 → 32: nh = int(120 * 0.2) = 24 (even) → box (24, 32)
    assert train.content_box == val.content_box == test.content_box == (24, 32)


def test_content_box_probes_every_record(tmp_path):
    """The repaired guard: ten training clips of one aspect and the last of
    another. The JAX trainer probes 8 records a dataset (every
    len // 8-th), misses the odd one and keeps the box; the port probes all
    of them and falls back to the square decode."""
    shapes = [(120, 160)] * 9 + [(90, 160)] + [(120, 160)] * 2
    train, val, test = _aspect_splits(tmp_path, shapes,
                                      ["train"] * 10 + ["val", "test"])
    # the JAX guard on the same records (its method, without a JAX trainer)
    stubs = [types.SimpleNamespace(records=ds.records, content_box=None)
             for ds in (train, val, test)]
    jax_self = types.SimpleNamespace(cfg=_box_config(),
                                     log=logging.getLogger("jax_guard"))
    JaxTrainer._enable_content_box(jax_self, *stubs)
    assert stubs[0].content_box == (24, 32)  # the odd clip went unseen
    tr = Trainer(_box_config(), train, val, test,
                 run_dir=str(tmp_path / "run"), device="cpu")
    assert train.content_box is None and test.content_box is None
    with open(os.path.join(tr.run_dir, "training.log")) as f:
        assert "mix aspect ratios" in f.read()


def test_content_box_survives_an_unreadable_clip(tmp_path):
    """A record that cannot be probed will not decode either: it is logged
    and has no say in the aspect, so one broken file does not turn the box
    off for the run."""
    train, val, test = _aspect_splits(
        tmp_path, [(120, 160)] * 4, ["train", "train", "val", "test"])
    train.records = train.records + [
        ClipRecord("missing", str(tmp_path / "missing.mp4"), 0)]
    tr = Trainer(_box_config(), train, val, test,
                 run_dir=str(tmp_path / "run"), device="cpu")
    assert train.content_box == test.content_box == (24, 32)
    with open(os.path.join(tr.run_dir, "training.log")) as f:
        assert "probe failed for 1 of 5 clips" in f.read()


def test_content_box_probe_failure_is_logged(tmp_path, monkeypatch):
    """Probes that all fail leave the box off and say so in the run's log.
    The JAX trainer catches any exception there; the port catches the
    errors a bad file gives (here ``MediaError``) and lets a media library
    that cannot be built raise."""
    train, val, test = _aspect_splits(
        tmp_path, [(120, 160)] * 4, ["train", "train", "val", "test"])

    def broken_probe(path):
        raise decoder.MediaError("probe exploded")

    monkeypatch.setattr(decoder, "probe", broken_probe)
    tr = Trainer(_box_config(), train, val, test,
                 run_dir=str(tmp_path / "run"), device="cpu")
    assert train.content_box is None
    with open(os.path.join(tr.run_dir, "training.log")) as f:
        text = f.read()
    assert "content-box transfer disabled" in text and "probe exploded" in text

    from vision_collision_detection_tpu_torch.media import MediaBuildError

    def unbuildable(path):
        raise MediaBuildError("no compiler")

    monkeypatch.setattr(decoder, "probe", unbuildable)
    with pytest.raises(MediaBuildError):
        Trainer(_box_config(), train, val, test,
                run_dir=str(tmp_path / "run2"), device="cpu")
