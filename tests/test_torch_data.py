"""The port's data layer against the JAX package's: ``ClipDataset`` samples
and native batches, ``ClipLoader``'s order and batches over epochs, the
dataset factories and metadata helpers; and the device feed on the CPU
(batches unchanged, the producer's early stop and its errors)."""

import os
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from vision_collision_detection_tpu.data import datasets as jax_datasets
from vision_collision_detection_tpu.data import loader as jax_loader
from vision_collision_detection_tpu.data import metadata as jax_metadata
from vision_collision_detection_tpu.media.synthetic import generate_dataset
from vision_collision_detection_tpu_torch.data import datasets, loader, metadata

NAMES = ("Normal", "Near Collision", "Collision")


@pytest.fixture(scope="module")
def meta(tmp_path_factory):
    """Six synthetic clips (30 frames of 64×96, sensors, a split column)
    and one file that is no video, as metadata rows."""
    d = tmp_path_factory.mktemp("data")
    df = pd.read_csv(generate_dataset(
        str(d), clips_per_class=2, num_frames=30, height=64, width=96,
        splits=("train", "val", "test")))
    broken = str(d / "videos" / "broken.mp4")
    with open(broken, "w") as f:
        f.write("not a video")
    row = {"id": "broken", "video_path": broken, "sensor_path": "",
           "video_type": "Collision", "event_time_sec": np.nan,
           "split": "test"}
    return pd.concat([df, pd.DataFrame([row])], ignore_index=True)


def _records(mod, df):
    return mod._records_from_df(df, NAMES)


DATASETS = {
    "center_box_sensors": dict(sample_strategy="center",
                               content_box=(22, 32), load_sensor=True),
    "random_stride2_sensors": dict(sample_strategy="random", frame_stride=2,
                                   load_sensor=True),
    "event_box_stride2": dict(sample_strategy="metadata_time",
                              content_box=(22, 32), frame_stride=2),
}


def _assert_batches_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        if k == "id":
            assert list(got[k]) == list(want[k])
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("name", list(DATASETS))
def test_clip_dataset_matches_jax(meta, name):
    kw = dict(fps=10, duration=2, frame_size=32, seed=7, **DATASETS[name])
    ours = datasets.ClipDataset(_records(datasets, meta), **kw)
    ref = jax_datasets.ClipDataset(_records(jax_datasets, meta), **kw)
    assert [vars(r) for r in ours.records] == [vars(r) for r in ref.records]
    assert (ours.out_frames, ours.out_hw) == (ref.out_frames, ref.out_hw)
    np.testing.assert_array_equal(ours.class_weights(), ref.class_weights())
    for epoch in (0, 1):
        for i in range(len(ours)):
            got, want = ours.get(i, epoch), ref.get(i, epoch)
            assert got["error"] == want["error"] == (i == len(ours) - 1)
            _assert_batches_equal(got, want)
        idxs = [6, 0, 3, 5, 1]
        got = ours.get_batch(idxs, epoch, num_threads=2)
        _assert_batches_equal(got, ref.get_batch(idxs, epoch, num_threads=2))
        np.testing.assert_array_equal(got["error"], [True] + [False] * 4)
        assert got["frames"][1:].any() and not got["frames"][0].any()
        if DATASETS[name].get("load_sensor"):
            assert got["sensor"][1:].any()


def test_dataset_factories_and_metadata_match_jax(meta, tmp_path):
    kw = dict(class_names=NAMES, fps=10, duration=2, frame_size=32)
    ours = datasets.create_datasets_with_manual_split(meta, **kw)
    want = jax_datasets.create_datasets_with_manual_split(meta, **kw)
    for a, b in zip(ours, want):
        assert [vars(r) for r in a.records] == [vars(r) for r in b.records]
        assert (a.sample_strategy, a.is_train) == (b.sample_strategy,
                                                   b.is_train)
        np.testing.assert_array_equal(a.class_weights(), b.class_weights())
    with pytest.raises(ValueError, match="split"):
        datasets.create_datasets_with_manual_split(meta.drop(columns="split"))

    videos = os.path.dirname(meta["video_path"][0])
    kw = dict(class_names=NAMES, min_samples_per_class=2, seed=3,
              fps=10, duration=2, frame_size=32)
    ours = datasets.create_datasets_from_directories(meta, [videos], **kw)
    want = jax_datasets.create_datasets_from_directories(meta, [videos], **kw)
    for a, b in zip(ours, want):
        assert [vars(r) for r in a.records] == [vars(r) for r in b.records]

    for fn, args in (("add_split_column_to_metadata", (meta,)),
                     ("add_peak_acceleration_timestamps", (meta,))):
        pd.testing.assert_frame_equal(getattr(metadata, fn)(*args),
                                      getattr(jax_metadata, fn)(*args))
    peaks = metadata.add_peak_acceleration_timestamps(meta)
    peaks["peak_accel_time_sec"] += 0.3
    pd.testing.assert_frame_equal(
        metadata.convert_absolute_to_relative_time(peaks),
        jax_metadata.convert_absolute_to_relative_time(peaks))
    assert metadata.find_video_path("normal_001", [videos]) == \
        jax_metadata.find_video_path("normal_001", [videos])
    assert metadata.infer_directory_structure([videos]) == \
        jax_metadata.infer_directory_structure([videos])
    np.testing.assert_array_equal(
        metadata.compute_class_weights([0, 0, 2, 2, 2], 3),
        jax_metadata.compute_class_weights([0, 0, 2, 2, 2], 3))


class StandIn:
    """Eleven samples that need no decode: frames, sensor and target carry
    the sample's index, and the 4th sample is flagged as broken."""

    def __init__(self, native):
        self.supports_batch = native

    def __len__(self):
        return 11

    def get(self, idx, epoch=0):
        return {"frames": np.full((2, 3, 4, 3), idx + 10 * epoch, np.uint8),
                "sensor": np.full((2, 4), idx, np.float32),
                "target": np.int64(idx % 3), "id": f"clip{idx}",
                "error": idx == 3}

    def get_batch(self, idxs, epoch=0, num_threads=0):
        return jax_loader.collate([self.get(int(i), epoch) for i in idxs])


LOADERS = {
    "plain": dict(),
    "shuffle": dict(shuffle=True),
    "shuffle_drop_last": dict(shuffle=True, drop_last=True),
    "shards3_rank0_pad": dict(shuffle=True, num_shards=3, shard_index=0,
                              pad_partial=True),
    "shards3_rank2_mask": dict(shuffle=True, num_shards=3, shard_index=2,
                               mask_wrap=True),
    "shards3_rank1_pad_mask": dict(num_shards=3, shard_index=1,
                                   pad_partial=True, mask_wrap=True),
}


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", list(LOADERS))
def test_loader_order_and_batches_match_jax(name, native):
    kw = dict(batch_size=3, num_workers=2, seed=5, **LOADERS[name])
    ours = loader.ClipLoader(StandIn(native), **kw)
    ref = jax_loader.ClipLoader(StandIn(native), **kw)
    for epoch in range(3):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        np.testing.assert_array_equal(ours._epoch_indices(),
                                      ref._epoch_indices())
        assert len(ours) == len(ref)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)


def test_device_feed_on_the_cpu_yields_the_batches_unchanged():
    ld = loader.ClipLoader(StandIn(True), batch_size=4, shuffle=True)
    want = list(ld)
    got = list(loader.device_feed(iter(ld), "cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in ("frames", "sensor", "target"):
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])
        assert g["id"] == w["id"]
        np.testing.assert_array_equal(g["error"], w["error"])


def _feed_threads():
    return [t for t in threading.enumerate() if t.name == "device_feed"]


def test_producer_stops_after_an_early_break():
    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    staged = []

    def stage(x):
        staged.append(x)
        return x * 10

    out = []
    for y in loader._produce(endless(), stage, depth=2):
        out.append(y)
        if len(out) == 3:
            break
    assert out == [0, 10, 20]
    assert not _feed_threads() and closed.is_set()
    assert len(staged) <= 3 + 2 + 1  # at most depth ahead, one in hand


def test_producer_error_reraises_in_the_consumer():
    def batches():
        yield 1
        yield 2
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for y in loader._produce(batches(), lambda x: x, depth=2):
            got.append(y)
            time.sleep(0.01)
    assert got == [1, 2] and not _feed_threads()

    def bad_stage(x):
        raise ValueError(f"cannot stage {x}")

    with pytest.raises(ValueError, match="cannot stage 1"):
        list(loader._produce(iter([1, 2]), bad_stage, depth=1))
    assert not _feed_threads()
