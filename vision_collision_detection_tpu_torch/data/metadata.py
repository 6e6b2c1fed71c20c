"""Metadata and CSV utilities.

Counterpart of ``vision_collision_detection_tpu/data/metadata.py``, the
reference's labelling aids: locating videos across directory layouts, IMU
peak-G event timestamps, absolute → relative event times clamped to the
video's duration, the stratified split column and inverse-frequency class
weights. pandas is imported inside the functions that need it; the
DataFrame annotations are strings.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional, Sequence

import numpy as np

from vision_collision_detection_tpu_torch.media.decoder import MediaError, probe
from vision_collision_detection_tpu_torch.media.sensors import (
    peak_acceleration_time,
    read_sensor_csv,
)

SENSOR_FILENAME = "Dashcam-Accelerometer_Acceleration.csv"

# Filename conventions across delivery batches.
VIDEO_FILENAME_FORMATS = (
    "{id}.mp4",
    "anonymized_{id}.mp4",
    "{id}.mov",
    "dash_{id}.mp4",
    "video_{id}.mp4",
    "dashcam_{id}.mp4",
)

# Directory layout patterns.
LAYOUT_PATTERNS: Dict[str, Dict[str, str]] = {
    "standard": {
        "video": "{base}/{id}/{id}.mp4",
        "sensor": "{base}/{id}/signals/" + SENSOR_FILENAME,
    },
    "anonymized": {
        "video": "{base}/{id}/anonymized_{id}.mp4",
        "sensor": "{base}/{id}/signals/" + SENSOR_FILENAME,
    },
    "flat": {
        "video": "{base}/{id}.mp4",
        "sensor": "{base}/signals/{id}/" + SENSOR_FILENAME,
    },
    "subfolder": {
        "video": "{base}/videos/{id}.mp4",
        "sensor": "{base}/signals/{id}/" + SENSOR_FILENAME,
    },
}


def find_video_path(video_id: str, base_dirs: Sequence[str],
                    check_sensors: bool = True,
                    sensor_subdir: str = "signals") -> dict:
    """Locate a video (and optionally its sensor CSV) across base dirs."""
    result = {
        "found": False, "video_path": None, "sensor_path": None,
        "directory": None, "video_format": None,
        "message": f"Video ID '{video_id}' not found in any directory.",
    }
    for base in base_dirs:
        vdir = os.path.join(base, str(video_id))
        candidates = []
        if os.path.isdir(vdir):
            candidates.append(vdir)
        for cand_dir in candidates + [base]:
            for fmt in VIDEO_FILENAME_FORMATS:
                vpath = os.path.join(cand_dir, fmt.format(id=video_id))
                if os.path.exists(vpath):
                    result.update(
                        found=True, video_path=vpath, directory=base,
                        video_format=os.path.basename(vpath),
                        message=f"Found video in {base}",
                    )
                    if check_sensors:
                        spath = os.path.join(
                            os.path.dirname(vpath), sensor_subdir, SENSOR_FILENAME
                        )
                        if os.path.exists(spath):
                            result["sensor_path"] = spath
                    return result
    return result


def infer_directory_structure(base_dirs, sample_ids=None, max_samples: int = 5) -> dict:
    """Count which layout pattern matches sample IDs in each base dir."""
    if isinstance(base_dirs, str):
        base_dirs = [base_dirs]
    if sample_ids is None or len(sample_ids) == 0:
        sample_ids = []
        for base in base_dirs:
            try:
                sample_ids.extend(
                    x for x in os.listdir(base) if not x.startswith(".")
                )
            except OSError:
                continue
    sample_ids = [str(s).replace(".mp4", "") for s in list(sample_ids)[:max_samples]]

    results = {name: {"count": 0, "examples": []} for name in LAYOUT_PATTERNS}
    for vid in sample_ids:
        for base in base_dirs:
            for name, pat in LAYOUT_PATTERNS.items():
                vpath = pat["video"].format(base=base, id=vid)
                if os.path.exists(vpath):
                    results[name]["count"] += 1
                    results[name]["examples"].append(vpath)
    best = max(results, key=lambda n: results[n]["count"])
    results["best_match"] = best if results[best]["count"] > 0 else None
    return results


def add_peak_acceleration_timestamps(
    metadata_df: pd.DataFrame,
    sensor_path_column: str = "sensor_path",
    out_column: str = "peak_accel_time_sec",
) -> pd.DataFrame:
    """Per row: peak total-G timestamp from the sensor CSV."""
    df = metadata_df.copy()
    times = []
    for _, row in df.iterrows():
        spath = row.get(sensor_path_column)
        if isinstance(spath, str) and spath and os.path.exists(spath):
            try:
                t, _ = peak_acceleration_time(spath)
                times.append(t)
                continue
            except (OSError, ValueError, KeyError):  # an unreadable CSV
                pass
        times.append(np.nan)
    df[out_column] = times
    return df


def convert_absolute_to_relative_time(
    metadata_df: pd.DataFrame,
    time_column: str = "peak_accel_time_sec",
    sensor_path_column: str = "sensor_path",
    video_path_column: str = "video_path",
    out_column: str = "event_time_sec",
) -> pd.DataFrame:
    """Absolute sensor timestamps → seconds-from-video-start, clamped to
    [0, video_duration]."""
    import pandas as pd

    df = metadata_df.copy()
    rel = []
    for _, row in df.iterrows():
        t_abs = row.get(time_column)
        spath = row.get(sensor_path_column)
        vpath = row.get(video_path_column)
        if pd.isna(t_abs) or not isinstance(spath, str) or not os.path.exists(spath):
            rel.append(np.nan)
            continue
        try:
            start = float(read_sensor_csv(spath)["time_sec"].iloc[0])
            t = float(t_abs) - start
            if isinstance(vpath, str) and os.path.exists(vpath):
                duration = probe(vpath).duration
                if duration > 0:
                    t = min(max(t, 0.0), duration)
            rel.append(max(t, 0.0))
        except (MediaError, OSError, ValueError, KeyError, IndexError):
            rel.append(np.nan)
    df[out_column] = rel
    return df


def add_split_column_to_metadata(
    metadata_df: pd.DataFrame,
    label_column: str = "video_type",
    split_column: str = "split",
    train_frac: float = 0.70,
    val_frac: float = 0.15,
    seed: int = 42,
) -> pd.DataFrame:
    """Stratified train/val/test split column."""
    df = metadata_df.copy()
    rng = np.random.default_rng(seed)
    split = np.empty(len(df), dtype=object)
    for label in df[label_column].unique():
        idx = np.flatnonzero((df[label_column] == label).to_numpy())
        perm = rng.permutation(idx)
        n = len(perm)
        n_train = int(round(n * train_frac))
        n_val = int(round(n * val_frac))
        split[perm[:n_train]] = "train"
        split[perm[n_train:n_train + n_val]] = "val"
        split[perm[n_train + n_val:]] = "test"
    df[split_column] = split
    return df


def copy_video_file(video_id: str, base_dirs: Sequence[str], dest_dir: str) -> Optional[str]:
    """Locate and copy a video into dest_dir."""
    info = find_video_path(video_id, base_dirs, check_sensors=False)
    if not info["found"]:
        return None
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, os.path.basename(info["video_path"]))
    shutil.copy2(info["video_path"], dest)
    return dest


def compute_class_weights(labels: Sequence[int], num_classes: int) -> np.ndarray:
    """Inverse-frequency class weights, as the reference computes them."""
    counts = np.bincount(np.asarray(labels, dtype=np.int64), minlength=num_classes)
    total = counts.sum()
    weights = np.where(counts > 0, total / np.maximum(counts, 1) / num_classes, 0.0)
    return weights.astype(np.float32)
