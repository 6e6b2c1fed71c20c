"""Preprocessing in float32: K1's function for serving, and a frozen copy of
the training preprocess with its draws.

``eval_frames`` is what K1 computes: uint8 letterbox content rows
[..., ch, cw, 3] → (x/255 − mean)/std placed at the centre of an S×S
frame whose bars take the normalised black −mean/std.

``train_frames`` is the training preprocess as the program draws it, so
that the reference sees the same flips and augmentation from the same
generator: a flip per clip (the first draw), letterbox, the per-clip
augmentation (``sample_clip_params``: every decision its own draw, in this
order), normalisation. It is frozen here: a later change to the program's
draw order is a change of what is computed, and shows as a gap. The
arithmetic is float32 throughout, where the program's separable warp
multiplies bf16 operands.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LUMA = (0.2989, 0.587, 0.114)


def eval_frames(frames_u8: torch.Tensor, S: int, mean, std) -> torch.Tensor:
    *lead, ch, cw, _ = frames_u8.shape
    dev = frames_u8.device
    m = torch.tensor(mean, dtype=torch.float32, device=dev)
    s = torch.tensor(std, dtype=torch.float32, device=dev)
    out = (-m / s).expand(*lead, S, S, 3).clone()
    ph, pw = (S - ch) // 2, (S - cw) // 2
    out[..., ph:ph + ch, pw:pw + cw, :] = (
        frames_u8.to(torch.float32) / 255.0 - m) / s
    return out


# ---- letterbox ------------------------------------------------------------

def letterbox_geometry(h: int, w: int, S: int):
    scale = min(S / h, S / w)
    new_h, new_w = int(h * scale), int(w * scale)
    return new_h, new_w, (S - new_h) // 2, (S - new_w) // 2


def letterbox_resize(frames: torch.Tensor, S: int) -> torch.Tensor:
    *lead, h, w, c = frames.shape
    if h == S and w == S:
        return frames
    new_h, new_w, pad_h, pad_w = letterbox_geometry(h, w, S)
    x = frames.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(new_h, new_w), mode="bilinear",
                      align_corners=False, antialias=True)
    x = F.pad(x, (pad_w, S - new_w - pad_w, pad_h, S - new_h - pad_h))
    return x.permute(0, 2, 3, 1).reshape(*lead, S, S, c)


# ---- color ------------------------------------------------------------------

def rgb_to_grayscale(x, keep_channels=True):
    w = torch.tensor(_LUMA, dtype=x.dtype, device=x.device)
    gray = torch.tensordot(x, w, dims=([-1], [0]))[..., None]
    return gray.expand(*x.shape) if keep_channels else gray


def adjust_brightness(x, f):
    return (x * f).clamp(0.0, 1.0)


def adjust_contrast(x, f):
    mean = rgb_to_grayscale(x, False).mean(dim=(-3, -2, -1), keepdim=True)
    return (f * x + (1.0 - f) * mean).clamp(0.0, 1.0)


def adjust_saturation(x, f):
    return (f * x + (1.0 - f) * rgb_to_grayscale(x)).clamp(0.0, 1.0)


def rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe_delta = torch.where(delta == 0, torch.ones_like(delta), delta)
    safe_max = torch.where(maxc == 0, torch.ones_like(maxc), maxc)
    s = torch.where(maxc == 0, torch.zeros_like(maxc), delta / safe_max)
    rc, gc, bc = ((maxc - c) / safe_delta for c in (r, g, b))
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    return torch.stack([torch.remainder(h / 6.0, 1.0), s, maxc], dim=-1)


def _select(i, choices):
    out = torch.zeros_like(choices[0])
    for k in range(len(choices) - 1, -1, -1):
        out = torch.where(i == k, choices[k], out)
    return out


def hsv_to_rgb(x):
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    return torch.stack([_select(i, (v, q, p, p, t, v)),
                        _select(i, (t, v, v, q, p, p)),
                        _select(i, (p, p, t, v, v, q))], dim=-1)


def adjust_hue(x, shift):
    hsv = rgb_to_hsv(x.clamp(0.0, 1.0))
    h = torch.remainder(hsv[..., 0] + shift, 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def posterize(x, bits):
    b = torch.floor(x.clamp(0.0, 1.0) * 255.0).to(torch.int32)
    bits = torch.as_tensor(bits, dtype=torch.int32, device=x.device)
    step = torch.bitwise_left_shift(torch.ones_like(bits), 8 - bits)
    return (torch.div(b, step, rounding_mode="floor") * step).to(x.dtype) / 255.0


# ---- affine -------------------------------------------------------------------

def _coeffs(angle_deg, shear_deg):
    rot = angle_deg * (math.pi / 180.0)
    sx = shear_deg * (math.pi / 180.0)
    a, c = torch.cos(rot), torch.sin(rot)
    b = -torch.cos(rot) * torch.tan(sx) - torch.sin(rot)
    d = -torch.sin(rot) * torch.tan(sx) + torch.cos(rot)
    return d, -b, -c, a


def _inverse_coeffs(h, w, angle, translate, scale, shear):
    ia, ib, ic, id_ = _coeffs(angle, shear)
    cx, cy = (w - 1) * 0.5, (h - 1) * 0.5
    tx, ty = translate[..., 0], translate[..., 1]
    ox = cx - (ia * (cx + tx) + ib * (cy + ty)) / scale
    oy = cy - (ic * (cx + tx) + id_ * (cy + ty)) / scale
    return (ia / scale, ib / scale, ox), (ic / scale, id_ / scale, oy)


def _band_weights(coords, n_in):
    xi = torch.arange(n_in, dtype=torch.float32, device=coords.device)
    return (1.0 - (coords[..., None] - xi).abs()).clamp_min(0.0)


def warp_separable(frames, angle, translate, scale, shear):
    """The two-pass bilinear warp (an x pass at integer rows, then a y pass
    in each column), in float32."""
    B, T, h, w, c = frames.shape
    (m00, m01, ox), (m10, m11, oy) = _inverse_coeffs(h, w, angle, translate,
                                                     scale, shear)
    eps = m01 / m11
    delta, zeta = m00 - eps * m10, ox - eps * oy
    col = lambda v: v[:, None, None]  # noqa: E731
    dev = frames.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    p = col(delta) * xs[None, None, :] + col(eps) * ys[None, :, None] + col(zeta)
    wx = _band_weights(p, w)
    src = frames.permute(0, 2, 3, 1, 4).reshape(B * h, w, T * c)
    tmp = torch.bmm(wx.reshape(B * h, w, w), src).reshape(B, h, w, T, c)
    q = col(m10) * xs[None, None, :] + col(m11) * ys[None, :, None] + col(oy)
    wy = _band_weights(q.transpose(1, 2), h)
    src = tmp.permute(0, 2, 1, 3, 4).reshape(B * w, h, T * c)
    out = torch.bmm(wy.reshape(B * w, h, h), src)
    return out.reshape(B, w, h, T, c).permute(0, 3, 2, 1, 4)


def warp_gather(frames, angle, translate, scale, shear):
    """The direct warp: four bilinear taps by gather, zero outside."""
    B, T, h, w, _ = frames.shape
    ia, ib, ic, id_ = (v[..., None, None] for v in _coeffs(angle, shear))
    scale = scale[..., None, None]
    cx, cy = (w - 1) * 0.5, (h - 1) * 0.5
    tx, ty = translate[..., 0, None, None], translate[..., 1, None, None]
    dev = frames.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    dx, dy = xs - cx - tx, ys - cy - ty
    src_x = (ia * dx + ib * dy) / scale + cx
    src_y = (ic * dx + id_ * dy) / scale + cy
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy = (src_y - y0)[:, None, ..., None]
    wx = (src_x - x0)[:, None, ..., None]
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    bi = torch.arange(B, device=dev)[:, None, None, None]
    ti = torch.arange(T, device=dev)[None, :, None, None]

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = frames[bi, ti, yi.clamp(0, h - 1)[:, None],
                      xi.clamp(0, w - 1)[:, None]]
        return torch.where(valid[:, None, ..., None], vals,
                           torch.zeros((), dtype=vals.dtype, device=dev))

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


# ---- augmentation ---------------------------------------------------------------

def sample_clip_params(generator, a: dict, h: int, w: int, batch: int):
    """The clips' parameters, drawn in the program's order."""
    lead, dev = (int(batch),), generator.device

    def rand(*shape):
        return torch.rand(lead + shape, generator=generator, device=dev)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * rand(*shape)

    def randint(lo, hi):
        return torch.randint(int(lo), int(hi) + 1, lead, generator=generator,
                             device=dev)

    k_max = int(a["cutout_count_range"][1])
    size_f = uniform(*a["cutout_size_range"], k_max)
    cut_h = torch.floor(h * size_f).to(torch.int32)
    cut_w = torch.floor(w * size_f).to(torch.int32)
    max_top = (h - cut_h - 1).clamp_min(0)
    max_left = (w - cut_w - 1).clamp_min(0)
    t_max = float(a["translate_range"][1])
    return {
        "skip": rand() > a["aug_probability"],
        "brightness": uniform(*a["brightness_range"]),
        "contrast": uniform(*a["contrast_range"]),
        "saturation": uniform(*a["saturation_range"]),
        "hue": uniform(*a["hue_range"]),
        "rotation": uniform(*a["rotation_range"]),
        "scale": uniform(*a["scale_range"]),
        "shear": uniform(*a["shear_range"]),
        "translate": torch.stack([uniform(-t_max, t_max) * w,
                                  uniform(-t_max, t_max) * h], dim=-1),
        "grayscale": rand() < a["grayscale_prob"],
        "cutout": rand() < a["cutout_prob"],
        "cutout_count": randint(*a["cutout_count_range"]),
        "cutout_h": cut_h,
        "cutout_w": cut_w,
        "cutout_top": torch.floor(rand(k_max) * (max_top + 1).float()
                                  ).to(torch.int32),
        "cutout_left": torch.floor(rand(k_max) * (max_left + 1).float()
                                   ).to(torch.int32),
        "invert": rand() < a["color_inversion_prob"],
        "solarize": rand() < a["solarization_prob"],
        "posterize": rand() < a["posterization_prob"],
        "posterize_bits": randint(*a["posterization_bits_range"]),
    }


def _reflect_index(n, half, device):
    i = torch.arange(-half, n + half, device=device).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def gaussian_blur(x, sigma):
    half = int(sigma * 4)
    xs = torch.arange(-half, half + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    k = k / k.sum()
    h, w = x.shape[-3], x.shape[-2]
    y = x.index_select(-3, _reflect_index(h, half, x.device))
    y = sum(k[i] * y[..., i:i + h, :, :] for i in range(k.shape[0]))
    y = y.index_select(-2, _reflect_index(w, half, x.device))
    return sum(k[i] * y[..., i:i + w, :] for i in range(k.shape[0]))


def _cutout_mask(h, w, p):
    top, left = p["cutout_top"][..., None, None], p["cutout_left"][..., None, None]
    ch, cw = p["cutout_h"][..., None, None], p["cutout_w"][..., None, None]
    dev = top.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    k_max = p["cutout_top"].shape[-1]
    active = p["cutout"][..., None] & (
        torch.arange(k_max, device=dev) < p["cutout_count"][..., None])
    inside = (ys >= top) & (ys < top + ch) & (xs >= left) & (xs < left + cw)
    return torch.where((inside & active[..., None, None]).any(dim=-3), 0.0, 1.0)


def augment(generator, frames, a: dict):
    """[B, T, H, W, C] in [0, 1] → augmented, each clip its own draws."""
    B, _, h, w, _ = frames.shape
    p = sample_clip_params(generator, a, h, w, B)
    per_clip = lambda v: v.reshape(B, 1, 1, 1, 1)  # noqa: E731
    x = adjust_brightness(frames, per_clip(p["brightness"]))
    x = adjust_contrast(x, per_clip(p["contrast"]))
    x = adjust_saturation(x, per_clip(p["saturation"]))
    x = adjust_hue(x, p["hue"].reshape(B, 1, 1, 1))
    warp = warp_separable if a["affine_mode"] == "separable" else warp_gather
    x = warp(x, p["rotation"], p["translate"], p["scale"], p["shear"])
    x = torch.where(per_clip(p["grayscale"]), rgb_to_grayscale(x), x)
    if a["noise_level"] > 0:
        noise = torch.randn(x.shape, generator=generator,
                            device=generator.device) * a["noise_level"]
        x = (x + noise).clamp(0.0, 1.0)
    if a["blur_sigma"] > 0:
        x = gaussian_blur(x, a["blur_sigma"])
    if a["posterization_prob"] > 0:
        x = torch.where(per_clip(p["posterize"]),
                        posterize(x, per_clip(p["posterize_bits"])), x)
    if a["solarization_prob"] > 0:
        x = torch.where(per_clip(p["solarize"]),
                        torch.where(x >= a["solarization_threshold"], 1.0 - x, x),
                        x)
    if a["color_inversion_prob"] > 0:
        x = torch.where(per_clip(p["invert"]), 1.0 - x, x)
    if a["cutout_prob"] > 0:
        x = x * _cutout_mask(h, w, p)[:, None, :, :, None]
    return torch.where(per_clip(p["skip"]), frames, x)


def train_frames(generator, frames_u8, a: dict, S: int) -> torch.Tensor:
    """uint8 [B, T, H, W, 3] → normalised float32 [B, T, S, S, 3], drawing
    from ``generator`` in the program's order: the flips, then the clips'
    parameters."""
    b = frames_u8.shape[0]
    flip = None
    if a["horizontal_flip_prob"] > 0:
        flip = torch.rand((b, 1, 1, 1, 1), generator=generator,
                          device=generator.device) < a["horizontal_flip_prob"]
    x = frames_u8.to(torch.float32) / 255.0
    x = letterbox_resize(x, S)
    if flip is not None:
        x = torch.where(flip, x.flip(-2), x)
    if a["enabled"]:
        x = augment(generator, x, a)
    mean = torch.tensor(a["normalize_mean"], dtype=torch.float32, device=x.device)
    std = torch.tensor(a["normalize_std"], dtype=torch.float32, device=x.device)
    return (x - mean) / std
