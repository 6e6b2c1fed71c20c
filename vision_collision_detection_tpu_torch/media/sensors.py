"""IMU accelerometer CSV loading and synchronisation with video frames.

Counterpart of ``vision_collision_detection_tpu/media/sensors.py``: the two
CSV schemas (the nvidia-1 header names
"Dashcam-Accelerometer.Acceleration", nvidia-2 is a plain
``time_sec/accel_{x,y,z}_G`` CSV), the total G, the peak-G timestamp and
linear interpolation of the samples onto frame timestamps. pandas is
imported inside the functions, so importing this module does not need it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

SENSOR_COLUMNS = ("accel_x_G", "accel_y_G", "accel_z_G", "accel_total_G")
_NVIDIA1_MARKER = "Dashcam-Accelerometer.Acceleration"


def read_sensor_csv(path: str):
    """→ DataFrame with columns time_sec + SENSOR_COLUMNS (schema-normalized)."""
    import pandas as pd

    with open(path, "r") as f:
        first_line = f.readline().strip()
    if _NVIDIA1_MARKER in first_line:
        cols = first_line.split(",")
        df = pd.read_csv(path, names=cols, skiprows=1)
        out = pd.DataFrame({
            "time_sec": df[cols[0]],
            "accel_x_G": df[cols[1]],
            "accel_y_G": df[cols[2]],
            "accel_z_G": df[cols[3]],
        })
    else:
        df = pd.read_csv(path)
        out = df[["time_sec", "accel_x_G", "accel_y_G", "accel_z_G"]].copy()
        if "accel_total_G" in df.columns:
            out["accel_total_G"] = df["accel_total_G"]
    if "accel_total_G" not in out.columns:
        out["accel_total_G"] = np.sqrt(
            out["accel_x_G"] ** 2 + out["accel_y_G"] ** 2 + out["accel_z_G"] ** 2
        )
    return out


def peak_acceleration_time(path: str) -> Tuple[float, float]:
    """(time_sec_of_peak, peak_total_G), the event-centering aid."""
    df = read_sensor_csv(path)
    i = int(df["accel_total_G"].idxmax())
    return float(df.loc[i, "time_sec"]), float(df.loc[i, "accel_total_G"])


def load_synced_sensor(
    sensor_path: Optional[str],
    video_fps: float,
    frame_count: int,
    default_dim: int = 4,
) -> np.ndarray:
    """→ float32 [frame_count, 4] aligned to frame timestamps i/fps.

    Missing or unreadable files, or zero fps, give zeros: the reference's
    fallback for bad data.
    """
    empty = np.zeros((frame_count, default_dim), dtype=np.float32)
    if not sensor_path or not os.path.exists(sensor_path):
        return empty
    if video_fps <= 0 or frame_count <= 0:
        return empty
    try:
        df = read_sensor_csv(sensor_path)
    except (OSError, ValueError, KeyError):  # unreadable: no sensor data
        return empty
    if len(df) == 0:
        return empty
    rel_t = (df["time_sec"] - df["time_sec"].iloc[0]).to_numpy(dtype=np.float64)
    frame_t = np.arange(frame_count, dtype=np.float64) / video_fps
    out = np.empty((frame_count, len(SENSOR_COLUMNS)), dtype=np.float32)
    for j, col in enumerate(SENSOR_COLUMNS):
        vals = df[col].to_numpy(dtype=np.float64)
        out[:, j] = np.interp(frame_t, rel_t, vals)
    return out
