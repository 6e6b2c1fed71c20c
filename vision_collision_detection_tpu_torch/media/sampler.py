"""Clip frame-index sampling strategies.

Counterpart of ``vision_collision_detection_tpu/media/sampler.py``, the
reference's start-frame math: ``random`` / ``center`` / ``metadata_time``
over contiguous frames, plus ``uniform`` sampling over the whole video. The
same ``np.random.Generator`` gives the same draws in both packages.

Strategies return ascending indices of length ``frames_needed``; indices past
the end of the video are kept (the decoder pads with the last decoded
frame).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def sample_clip_indices(
    strategy: str,
    num_frames: int,
    frames_needed: int,
    *,
    video_fps: float = 0.0,
    event_time_sec: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Return int64 indices [frames_needed] into a video of `num_frames`."""
    if num_frames <= 0:
        raise ValueError("num_frames must be positive")
    if strategy == "uniform":
        # notebook-API behavior: spread over the whole video
        return np.linspace(0, num_frames - 1, frames_needed).astype(np.int64)

    if strategy == "metadata_time" and event_time_sec is not None and video_fps > 0:
        frames_half = frames_needed // 2
        center_frame = int(event_time_sec * video_fps)
        start = max(0, center_frame - frames_half)
        if start + frames_needed > num_frames:
            start = max(0, num_frames - frames_needed)
        start = max(0, min(start, num_frames - 1))
    elif strategy == "center":
        if num_frames > frames_needed:
            start = max(0, num_frames // 2 - frames_needed // 2)
            if start + frames_needed > num_frames:
                start = max(0, num_frames - frames_needed)
        else:
            start = 0
    elif strategy in ("random", "metadata_time"):
        # metadata_time without usable metadata falls back to random, as
        # in the reference.
        rng = rng or np.random.default_rng()
        if num_frames > frames_needed:
            start = int(rng.integers(0, num_frames - frames_needed + 1))
        else:
            start = 0
    else:
        raise ValueError(f"unknown sample strategy {strategy!r}")

    start = max(0, min(start, num_frames - 1))
    return np.arange(start, start + frames_needed, dtype=np.int64)
