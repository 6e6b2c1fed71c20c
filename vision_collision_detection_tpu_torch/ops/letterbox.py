"""Letterbox resize: aspect-preserving scale + centred zero padding.

``letterbox_geometry`` is the JAX package's int-floor arithmetic
(``scale = min(S/h, S/w)``, ``new = int(dim * scale)``, ``pad = (S - new) // 2``).
The resize is ``F.interpolate(mode="bilinear", antialias=True)``, the
filter that ``jax.image.resize(method="linear", antialias=True)`` matches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def letterbox_geometry(h: int, w: int, target_size: int):
    """(new_h, new_w, pad_h, pad_w) with int-floor arithmetic."""
    scale = min(target_size / h, target_size / w)
    new_h = int(h * scale)
    new_w = int(w * scale)
    pad_h = (target_size - new_h) // 2
    pad_w = (target_size - new_w) // 2
    return new_h, new_w, pad_h, pad_w


def letterbox_resize(frames: torch.Tensor, target_size: int) -> torch.Tensor:
    """[..., H, W, C] float → [..., S, S, C]; aspect preserved, black pad.
    Returns the input when it is already S×S."""
    *lead, h, w, c = frames.shape
    if h == target_size and w == target_size:
        return frames
    new_h, new_w, pad_h, pad_w = letterbox_geometry(h, w, target_size)
    x = frames.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(new_h, new_w), mode="bilinear",
                      align_corners=False, antialias=True)
    x = F.pad(x, (pad_w, target_size - new_w - pad_w,
                  pad_h, target_size - new_h - pad_h))
    return x.permute(0, 2, 3, 1).reshape(*lead, target_size, target_size, c)
