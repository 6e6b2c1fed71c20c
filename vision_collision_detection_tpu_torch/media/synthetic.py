"""Synthetic dashcam fixture generator: MP4s, IMU CSVs and a metadata CSV.

Counterpart of ``vision_collision_detection_tpu/media/synthetic.py``: the
same seed gives the same frames, CSV rows and files, written through the
port's encoder. The file contract is the reference's: videos, one
accelerometer CSV per video (nvidia-2 schema), and a metadata CSV with
``id / video_path / sensor_path / video_type / event_time_sec`` (and
``split``) columns, with a class-correlated visual and IMU signal. pandas is
imported inside ``generate_dataset``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from vision_collision_detection_tpu_torch.media.decoder import encode_video

CLASS_NAMES = ("Normal", "Near Collision", "Collision")


def _make_clip(rng: np.random.Generator, label: int, n: int, h: int, w: int,
               hard: bool = False):
    """Class-correlated moving-box clip + accel trace.

    label 0 (Normal): box drifts slowly, flat accel.
    label 1 (Near Collision): box approaches fast, braking accel bump.
    label 2 (Collision): box fills frame mid-clip, white flash + accel spike.

    hard=True makes the visual signal deliberately ambiguous — speeds
    drawn from OVERLAPPING per-class ranges, the impact flash only half
    the time, box color decorrelated from the class, and sensor noise —
    so a briefly-fitted model lands at a mid-range (non-saturated) AUC.
    Saturated rankings (AUC 1.0 on both sides) can hide small systematic
    pipeline shifts; parity legs need scores the drift can actually move.
    """
    frames = np.zeros((n, h, w, 3), dtype=np.uint8)
    base = rng.integers(30, 90, size=3)
    frames[..., 0] = base[0]
    frames[..., 1] = base[1]
    frames[..., 2] = base[2]
    event_frame = n // 2 + int(rng.integers(-n // 8, n // 8 + 1))
    if hard:
        # class speed ranges overlap pairwise: 0:[0.2,0.9] 1:[0.5,1.3] 2:[0.8,1.8]
        lo, hi = [(0.2, 0.9), (0.5, 1.3), (0.8, 1.8)][label]
        speed = float(rng.uniform(lo, hi))
    else:
        speed = [0.2, 0.8, 1.6][label]
    accel = rng.normal(0.0, 0.02, size=(n, 3)).astype(np.float64)
    accel[:, 2] += 1.0  # gravity

    flash = (not hard) or bool(rng.integers(0, 2))
    for i in range(n):
        # box grows as it "approaches"; growth rate encodes the class
        progress = min(1.0, speed * i / n)
        bh = int(h * (0.1 + 0.6 * progress))
        bw = int(w * (0.1 + 0.6 * progress))
        top = (h - bh) // 2 + int(4 * np.sin(i / 5.0))
        left = (w - bw) // 2 + int(6 * np.cos(i / 7.0))
        top = max(0, min(h - bh, top))
        left = max(0, min(w - bw, left))
        if hard:  # color carries no class signal on hard clips
            color = np.array([200, int(rng.integers(40, 180)), 60], np.uint8)
        else:
            color = np.array([200, 60 + 60 * label, 60], dtype=np.uint8)
        frames[i, top:top + bh, left:left + bw] = color
        if label == 2 and abs(i - event_frame) <= 1 and flash:
            frames[i] = 255  # impact flash
    if hard:
        # texture noise decorrelates low-level statistics from the label
        noise = rng.integers(-12, 13, size=(n, h, w, 1)).astype(np.int16)
        frames = np.clip(frames.astype(np.int16) + noise, 0, 255).astype(
            np.uint8)
    if label == 1:
        accel[event_frame:event_frame + 5, 0] -= 0.8  # braking
    if label == 2:
        accel[event_frame, :] += rng.normal(3.0, 0.3, size=3)  # impact spike
    return frames, accel, event_frame


def generate_dataset(
    out_dir: str,
    clips_per_class: int = 4,
    num_frames: int = 50,
    fps: float = 10.0,
    height: int = 64,
    width: int = 96,
    seed: int = 42,
    class_names: Sequence[str] = CLASS_NAMES,
    with_sensors: bool = True,
    splits: Optional[Sequence[str]] = None,
    codec: str = "mpeg4",
    hard: bool = False,
) -> str:
    """Write videos/ sensors/ and metadata.csv under out_dir; returns csv path.

    ``splits`` (optional) assigns train/val/test round-robin per class,
    producing the manual-split column contract.
    ``codec="h264"`` encodes with disposable B-frames (libx264, bframes=2,
    1-s GOP) — the stream family real dashcams emit, which exercises the
    decoder's non-ref skip and B-frame seek paths.
    ``hard`` → ambiguous class signal (see _make_clip) for non-saturated
    AUC parity legs.
    """
    import pandas as pd

    rng = np.random.default_rng(seed)
    video_dir = os.path.join(out_dir, "videos")
    sensor_dir = os.path.join(out_dir, "sensors")
    os.makedirs(video_dir, exist_ok=True)
    os.makedirs(sensor_dir, exist_ok=True)

    rows = []
    for label, cname in enumerate(class_names):
        for k in range(clips_per_class):
            vid = f"{cname.lower().replace(' ', '_')}_{k:03d}"
            frames, accel, event_frame = _make_clip(
                rng, label, num_frames, height, width, hard=hard
            )
            vpath = os.path.join(video_dir, f"{vid}.mp4")
            if codec == "h264":
                encode_video(vpath, frames, fps=fps, codec="libx264",
                             gop=int(fps), bframes=2, crf=23,
                             preset="ultrafast")
            else:
                encode_video(vpath, frames, fps=fps)
            spath = ""
            if with_sensors:
                spath = os.path.join(sensor_dir, f"{vid}.csv")
                t = np.arange(num_frames) / fps
                total = np.sqrt((accel ** 2).sum(axis=1))
                pd.DataFrame({
                    "time_sec": t,
                    "accel_x_G": accel[:, 0],
                    "accel_y_G": accel[:, 1],
                    "accel_z_G": accel[:, 2],
                    "accel_total_G": total,
                }).to_csv(spath, index=True)
            row = {
                "id": vid,
                "video_path": vpath,
                "sensor_path": spath,
                "video_type": cname,
                "event_time_sec": event_frame / fps,
            }
            if splits is not None:
                row["split"] = splits[k % len(splits)]
            rows.append(row)

    csv_path = os.path.join(out_dir, "metadata.csv")
    pd.DataFrame(rows).to_csv(csv_path, index=False)
    return csv_path
