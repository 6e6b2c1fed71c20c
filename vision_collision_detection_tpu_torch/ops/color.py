"""Color ops on [0, 1] float RGB, torchvision-compatible semantics.

Counterpart of ``vision_collision_detection_tpu/ops/color.py``: brightness,
contrast, saturation, hue (an HSV round trip), grayscale, solarize,
posterize and invert over [..., H, W, C]. A factor may be a number or a
tensor that broadcasts against the frames (for example one value per clip,
shaped [B, 1, 1, 1, 1]); ``adjust_hue``'s shift broadcasts against one
channel, [..., H, W].
"""

from __future__ import annotations

import torch

# ITU-R 601 luma weights (torchvision rgb_to_grayscale).
_LUMA = (0.2989, 0.587, 0.114)


def rgb_to_grayscale(x: torch.Tensor, keep_channels: bool = True) -> torch.Tensor:
    w = torch.tensor(_LUMA, dtype=x.dtype, device=x.device)
    gray = torch.tensordot(x, w, dims=([-1], [0]))[..., None]
    if keep_channels:
        gray = gray.expand(*x.shape)
    return gray


def adjust_brightness(x: torch.Tensor, factor) -> torch.Tensor:
    return (x * factor).clamp(0.0, 1.0)


def adjust_contrast(x: torch.Tensor, factor) -> torch.Tensor:
    # blend with the mean of the grayscale image (per image over H, W)
    gray = rgb_to_grayscale(x, keep_channels=False)
    mean = gray.mean(dim=(-3, -2, -1), keepdim=True)
    return (factor * x + (1.0 - factor) * mean).clamp(0.0, 1.0)


def adjust_saturation(x: torch.Tensor, factor) -> torch.Tensor:
    gray = rgb_to_grayscale(x, keep_channels=True)
    return (factor * x + (1.0 - factor) * gray).clamp(0.0, 1.0)


def rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    safe_delta = torch.where(delta == 0, torch.ones_like(delta), delta)
    safe_max = torch.where(maxc == 0, torch.ones_like(maxc), maxc)
    s = torch.where(maxc == 0, torch.zeros_like(maxc), delta / safe_max)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    h = torch.remainder(h / 6.0, 1.0)
    return torch.stack([h, s, v], dim=-1)


def _select(i: torch.Tensor, choices) -> torch.Tensor:
    """``jnp.select([i == 0, ..., i == 5], choices)``."""
    out = torch.zeros_like(choices[0])
    for k in range(len(choices) - 1, -1, -1):
        out = torch.where(i == k, choices[k], out)
    return out


def hsv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    r = _select(i, (v, q, p, p, t, v))
    g = _select(i, (t, v, v, q, p, p))
    b = _select(i, (p, p, t, v, v, q))
    return torch.stack([r, g, b], dim=-1)


def adjust_hue(x: torch.Tensor, shift) -> torch.Tensor:
    """shift ∈ [-0.5, 0.5] of the full hue cycle."""
    hsv = rgb_to_hsv(x.clamp(0.0, 1.0))
    h = torch.remainder(hsv[..., 0] + shift, 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def solarize(x: torch.Tensor, threshold) -> torch.Tensor:
    return torch.where(x >= threshold, 1.0 - x, x)


def posterize(x: torch.Tensor, bits) -> torch.Tensor:
    """Quantize to ``bits`` bits per channel (byte-domain semantics): mask
    the low 8 - bits bits of the byte value. ``bits`` may be an int tensor
    that broadcasts against x."""
    b = torch.floor(x.clamp(0.0, 1.0) * 255.0).to(torch.int32)
    bits = torch.as_tensor(bits, dtype=torch.int32, device=x.device)
    step = torch.bitwise_left_shift(torch.ones_like(bits), 8 - bits)
    q = torch.div(b, step, rounding_mode="floor") * step
    return q.to(x.dtype) / 255.0


def invert(x: torch.Tensor) -> torch.Tensor:
    return 1.0 - x
