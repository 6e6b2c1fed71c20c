"""The port's media layer against the JAX package's: probe, decode (bit
for bit, on the clips of tests/test_media.py), batch decode, the encoder,
frame-index sampling, sensor sync, the synthetic fixtures, the lowres
repair, and a build that leaves the JAX package's library alone."""

import ctypes
import hashlib
import os

import numpy as np
import pytest

from vision_collision_detection_tpu.media import decoder as jax_dec
from vision_collision_detection_tpu.media import sampler as jax_sampler
from vision_collision_detection_tpu.media import sensors as jax_sensors
from vision_collision_detection_tpu.media import synthetic as jax_synthetic
from vision_collision_detection_tpu_torch.media import build, decoder, sampler
from vision_collision_detection_tpu_torch.media import sensors, synthetic
from vision_collision_detection_tpu_torch.ops.letterbox import (
    letterbox_geometry,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SRC = os.path.join(ROOT, "vision_collision_detection_tpu", "media", "_src")


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """The three clip families of tests/test_media.py, written by the JAX
    encoder: an mpeg4 ramp (50 frames, 120×160), an H.264 stream with
    B-frames and a scene cut (96 frames, 96×128) and a textured 320×480
    mpeg4 clip (12 frames). → {name: (path, frames, h, w)}."""
    d = tmp_path_factory.mktemp("media")
    out = {}
    n, h, w = 50, 120, 160
    frames = np.zeros((n, h, w, 3), np.uint8)
    for i in range(n):
        frames[i, :, :, 0] = int(i * 255 / (n - 1))
    jax_dec.encode_video(str(d / "ramp.mp4"), frames, fps=10)
    out["ramp"] = (str(d / "ramp.mp4"), n, h, w)
    n, h, w = 96, 96, 128
    frames = np.zeros((n, h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for t in range(n):
        base = ((xx * 2 + t * 5) % 256) if t < 40 else ((yy * 3 + t * 7 + 128) % 256)
        frames[t, ..., 0] = base
        frames[t, ..., 1] = (base + 85) % 256
        frames[t, ..., 2] = (base + 170) % 256
    jax_dec.encode_video(str(d / "bframes.mp4"), frames, fps=10,
                         codec="libx264", gop=48, bframes=3, crf=20.0,
                         preset="medium")
    out["bframes"] = (str(d / "bframes.mp4"), n, h, w)
    n, h, w = 12, 320, 480
    frames = (np.random.default_rng(7).random((n, h, w, 3)) * 255).astype(
        np.uint8)
    jax_dec.encode_video(str(d / "textured.mp4"), frames, fps=10)
    out["textured"] = (str(d / "textured.mp4"), n, h, w)
    return out


NAMES = ("ramp", "bframes", "textured")


@pytest.mark.parametrize("name", NAMES)
def test_probe_matches_jax(clips, name):
    path = clips[name][0]
    assert decoder.probe(path) == decoder.VideoInfo(
        **vars(jax_dec.probe(path)))


# A rectangular letterbox canvas of each clip's aspect, the content spanning
# it (a content box). Where a box leaves the content a column narrower than
# the canvas, the JAX package's decoder is at fault and the two differ:
# test_content_one_column_narrower_than_its_box holds that case.
BOX = {"ramp": (48, 64), "bframes": (48, 64), "textured": (40, 60)}


MODES = ("native", "letterbox", "content_box", "eof", "fast_resize",
         "stretch")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_decode_frames_bit_equal_to_jax(clips, name, mode):
    path, n, h, w = clips[name]
    idx = list(range(0, n, max(1, n // 8)))
    kw = {
        "native": {},
        "letterbox": {"target_size": 64},
        "content_box": {"target_size": BOX[name]},
        "eof": {"target_size": 64},
        "fast_resize": {"target_size": BOX[name], "fast_resize": True},
        "stretch": {"target_size": (40, 56), "letterbox": False},
    }[mode]
    if mode == "eof":
        idx = [n - 3, n - 1, n + 4, n + 9]
    got = decoder.decode_frames(path, idx, **kw)
    want = jax_dec.decode_frames(path, idx, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if mode == "eof":
        np.testing.assert_array_equal(got[2], got[1])
        np.testing.assert_array_equal(got[3], got[1])
    if mode == "content_box" and name == "ramp":
        assert got.shape[1:3] == (48, 64)  # 3:4 into 64²: content only


def test_per_call_flags_do_not_touch_the_globals(clips):
    path = clips["textured"][0]
    assert not decoder.get_fast_resize() and decoder.get_lowres() == 0
    fast = decoder.decode_frames(path, [0, 5], (64, 96), fast_resize=True)
    low = decoder.decode_frames(path, [0, 5], (64, 96), lowres=1)
    assert not decoder.get_fast_resize() and decoder.get_lowres() == 0
    exact = decoder.decode_frames(path, [0, 5], (64, 96))
    assert not np.array_equal(fast, exact) and not np.array_equal(low, exact)
    np.testing.assert_array_equal(
        low, jax_dec.decode_frames(path, [0, 5], (64, 96), lowres=1))
    try:  # the global default is the port library's own, not the JAX one's
        decoder.set_fast_resize(True)
        assert not jax_dec.get_fast_resize()
        np.testing.assert_array_equal(
            decoder.decode_frames(path, [0, 5], (64, 96)), fast)
        np.testing.assert_array_equal(
            decoder.decode_frames(path, [0, 5], (64, 96), fast_resize=False),
            exact)
    finally:
        decoder.set_fast_resize(False)


def test_skip_unneeded_and_profile_counters_match_jax(clips):
    path, n, _, _ = clips["bframes"]
    idx = list(range(0, n, 7))
    counts = {}
    for mod in (decoder, jax_dec):
        mod.profile_decode(True)
        try:
            frames = mod.decode_frames(path, idx)
            prof = mod.decode_profile()
        finally:
            mod.profile_decode(False)
        counts[mod] = (frames, {k: v for k, v in prof.items()
                                if not k.endswith("_s")})
    (a, pa), (b, pb) = counts[decoder], counts[jax_dec]
    np.testing.assert_array_equal(a, b)
    assert pa == pb and pa["frames_skipped_nonref"] > 0
    try:
        decoder.set_skip_unneeded(False)
        np.testing.assert_array_equal(decoder.decode_frames(path, idx), a)
    finally:
        decoder.set_skip_unneeded(True)
    assert not decoder.get_fast_decode()


def test_decode_batch_equals_single_decodes_and_jax(clips, tmp_path):
    path, n, h, w = clips["bframes"]
    broken = str(tmp_path / "broken.mp4")
    with open(broken, "w") as f:
        f.write("not a video")
    idx = np.stack([np.arange(0, n, 9), np.arange(3, n, 9)[:11],
                    np.arange(0, n, 9)]).astype(np.int64)
    paths = [path, clips["ramp"][0], broken]
    box = BOX["bframes"]
    frames, ok = decoder.decode_batch(paths, idx, box, num_threads=2)
    want, want_ok = jax_dec.decode_batch(paths, idx, box, num_threads=2)
    np.testing.assert_array_equal(ok, [True, True, False])
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(frames[:2], want[:2])
    for k in range(2):
        np.testing.assert_array_equal(
            frames[k], decoder.decode_frames(paths[k], idx[k], box))
    with pytest.raises(decoder.MediaError):
        decoder.decode_frames(broken, [0])


@pytest.mark.parametrize("writer", ["encode_video", "VideoWriter"])
def test_port_encoder_gives_the_jax_encoders_frames(tmp_path, writer):
    frames = (np.random.default_rng(11).random((12, 48, 64, 3)) * 255
              ).astype(np.uint8)
    ours, ref = str(tmp_path / "ours.mp4"), str(tmp_path / "ref.mp4")
    if writer == "encode_video":
        decoder.encode_video(ours, frames, fps=6.0)
    else:
        with decoder.VideoWriter(ours, w=64, h=48, fps=6.0) as vw:
            vw.append(frames[:5])
            vw.append(frames[5:11])
            vw.append(frames[11])
        assert vw.frames_written == 12
        with pytest.raises(decoder.MediaError):
            vw.append(frames[:1])
    jax_dec.encode_video(ref, frames, fps=6.0)
    assert jax_dec.probe(ours) == jax_dec.probe(ref)
    np.testing.assert_array_equal(jax_dec.decode_frames(ours, range(12)),
                                  jax_dec.decode_frames(ref, range(12)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("strategy",
                         ["random", "center", "metadata_time", "uniform"])
def test_sample_clip_indices_matches_jax(strategy, seed):
    for num_frames, needed, fps, t in ((150, 50, 30.0, 2.0), (30, 50, 10.0, 1.0),
                                       (300, 50, 30.0, 9.9), (80, 50, 0.0, None),
                                       (51, 50, 10.0, None)):
        got = sampler.sample_clip_indices(
            strategy, num_frames, needed, video_fps=fps, event_time_sec=t,
            rng=np.random.default_rng(seed))
        want = jax_sampler.sample_clip_indices(
            strategy, num_frames, needed, video_fps=fps, event_time_sec=t,
            rng=np.random.default_rng(seed))
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        sampler.sample_clip_indices(strategy, 0, 5)


@pytest.mark.parametrize("schema", ["nvidia1", "nvidia2"])
def test_sensor_sync_and_peak_match_jax(tmp_path, schema):
    import pandas as pd

    t = np.arange(0, 5, 0.02) + 1000.0
    ax, az = np.sin(t), np.ones_like(t)
    az[100] = 5.0
    path = str(tmp_path / "sensor.csv")
    if schema == "nvidia1":
        cols = ["t", "Dashcam-Accelerometer.Acceleration.x", "y", "z"]
        pd.DataFrame(dict(zip(cols, (t, ax, np.zeros_like(t), az)))).to_csv(
            path, index=False)
    else:
        pd.DataFrame({"time_sec": t, "accel_x_G": ax, "accel_y_G": 0 * t,
                      "accel_z_G": az}).to_csv(path, index=True)
    assert sensors.peak_acceleration_time(path) == \
        jax_sensors.peak_acceleration_time(path)
    got = sensors.load_synced_sensor(path, video_fps=10.0, frame_count=50)
    want = jax_sensors.load_synced_sensor(path, video_fps=10.0, frame_count=50)
    assert got.dtype == np.float32 and got.shape == (50, 4)
    np.testing.assert_array_equal(got, want)
    assert sensors.load_synced_sensor("/nope.csv", 10.0, 5).sum() == 0


def test_synthetic_dataset_matches_jax(tmp_path):
    import pandas as pd

    kw = dict(clips_per_class=1, num_frames=12, height=40, width=56, seed=3,
              splits=("train", "val"), hard=True)
    ours = pd.read_csv(synthetic.generate_dataset(str(tmp_path / "a"), **kw))
    ref = pd.read_csv(jax_synthetic.generate_dataset(str(tmp_path / "b"), **kw))
    for df, d in ((ours, "a"), (ref, "b")):
        for col in ("video_path", "sensor_path"):
            df[col] = [os.path.relpath(p, tmp_path / d) for p in df[col]]
    pd.testing.assert_frame_equal(ours, ref)
    for rel_v, rel_s in zip(ours["video_path"], ours["sensor_path"]):
        np.testing.assert_array_equal(
            jax_dec.decode_frames(str(tmp_path / "a" / rel_v), range(12)),
            jax_dec.decode_frames(str(tmp_path / "b" / rel_v), range(12)))
        with open(tmp_path / "a" / rel_s) as fa, open(tmp_path / "b" / rel_s) as fb:
            assert fa.read() == fb.read()


def test_content_one_column_narrower_than_its_box(clips):
    """A repaired reference fault. The content box of a 320×480 clip at 64²
    is (42, 64), and the letterbox of 480 columns into it is 63 wide, with
    the odd column at the right. The JAX package's decoder writes those
    rows 63 wide at a stride of 64 and leaves the frame's last 42 pixels
    unwritten (they differ from call to call). The port's decoder gives the
    42×63 resize, the same as a plain resize to 42×63, and a black last
    column, the same on every call."""
    path, n, h, w = clips["textured"]
    nh, nw, _, _ = letterbox_geometry(h, w, 64)
    box = (nh + nh % 2, nw + nw % 2)
    assert box == (42, 64)
    idx = list(range(n))
    got = decoder.decode_frames(path, idx, box)
    want = np.zeros_like(got)
    want[:, :, :63] = decoder.decode_frames(path, idx, (42, 63),
                                            letterbox=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(decoder.decode_frames(path, idx, box), got)
    frames, ok = decoder.decode_batch([path], np.asarray([idx]), box)
    assert ok.all()
    np.testing.assert_array_equal(frames[0], got)
    assert not np.array_equal(jax_dec.decode_frames(path, idx, box), got)


@pytest.mark.parametrize("entry", ["decode_frames", "c_entry"])
def test_lowres_without_a_canvas_decodes_full_size(clips, entry):
    """The repaired reference fault: with no target size and lowres 1, the
    JAX package fills a buffer of the probed size with half-size frames.
    The port decodes full-size frames there (in Python, and in its C copy
    when asked directly), equal to the same call with lowres 0."""
    path, n, h, w = clips["ramp"]  # mpeg4: libavcodec decodes it at lowres
    idx = [0, 10, 20]
    full = decoder.decode_frames(path, idx, lowres=0)
    if entry == "decode_frames":
        got = decoder.decode_frames(path, idx, lowres=1)
    else:
        got = _c_decode(decoder._get_lib(), path, idx, h, w, lowres=1)
        jax_got = _c_decode(jax_dec._get_lib(), path, idx, h, w, lowres=1)
        assert not np.array_equal(jax_got, full)  # the fault, in the JAX copy
    assert got.shape == full.shape == (3, h, w, 3)
    np.testing.assert_array_equal(got, full)


def _c_decode(lib, path, idx, h, w, lowres):
    """``vcd_decode3`` at native size (target 0×0) into an [n, h, w, 3]
    buffer, as ``decode_frames`` calls it when ``target_size`` is None."""
    idx = np.asarray(idx, np.int64)
    out = np.zeros((len(idx), h, w, 3), np.uint8)
    got = lib.vcd_decode3(
        path.encode(), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        len(idx), 0, 0, 0, -1, lowres,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    assert got == len(idx)
    return out


def _snapshot(d):
    return {name: (hashlib.sha256(open(os.path.join(d, name), "rb").read())
                   .hexdigest(), os.stat(os.path.join(d, name)).st_mtime_ns)
            for name in sorted(os.listdir(d))}


def test_build_leaves_the_jax_library_alone(tmp_path, monkeypatch):
    jax_dec._get_lib()  # the JAX package's own build, if it needs one, first
    before = _snapshot(JAX_SRC)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "media")
    lib = build.build()
    assert lib.is_file() and str(lib).startswith(str(tmp_path / "media"))
    assert os.listdir(lib.parent) == [build.LIB_NAME]  # no temp file left
    assert build.build() == lib
    assert _snapshot(JAX_SRC) == before


def test_missing_source_raises_media_build_error(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "SOURCE", tmp_path / "nothing.cpp")
    monkeypatch.setattr(decoder, "_lib", None)
    with pytest.raises(build.MediaBuildError, match="source missing"):
        decoder.probe(str(tmp_path / "x.mp4"))
    assert not issubclass(build.MediaBuildError, decoder.MediaError)
