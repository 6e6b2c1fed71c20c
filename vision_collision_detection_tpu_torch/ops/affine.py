"""Affine warp (rotate / scale / shear / translate) with bilinear sampling.

Counterpart of ``vision_collision_detection_tpu/ops/affine.py``: angle in
degrees (CCW), scale factor, x-shear in degrees, translation in pixels,
pivot at the image centre, zero fill; one coordinate map per clip, shared
by its T frames. Parameters are tensors with a leading batch shape (one
value per clip, ``translate_xy`` [..., 2]); the frames are
[..., T, H, W, C] with the same leading shape.

Two warps, as in the JAX package: the direct gather warp
(``affine_warp_clip``), and the separable two-pass warp
(``affine_warp_clip_separable``), whose two resampling passes are batched
products of bf16 operands with float32 results, as the JAX einsums with
``preferred_element_type=jnp.float32`` (products, not a kernel).
"""

from __future__ import annotations

import math

import torch


def _coeffs(angle_deg, shear_deg):
    """The inverse 2×2 map (det 1 before scale) of R(angle)·Shear_x(shear)."""
    rot = angle_deg * (math.pi / 180.0)
    sx = shear_deg * (math.pi / 180.0)
    a = torch.cos(rot)
    b = -torch.cos(rot) * torch.tan(sx) - torch.sin(rot)
    c = torch.sin(rot)
    d = -torch.sin(rot) * torch.tan(sx) + torch.cos(rot)
    return d, -b, -c, a


def affine_grid(h: int, w: int, angle_deg, translate_xy, scale, shear_deg):
    """(src_y, src_x) float32 grids [..., H, W]: output pixel → input
    coordinates, for parameters of leading shape [...]."""
    angle_deg, scale, shear_deg = (torch.as_tensor(v, dtype=torch.float32)
                                   for v in (angle_deg, scale, shear_deg))
    translate_xy = torch.as_tensor(translate_xy, dtype=torch.float32)
    ia, ib, ic, id_ = (v[..., None, None] for v in _coeffs(angle_deg,
                                                            shear_deg))
    scale = scale[..., None, None]
    cx = (w - 1) * 0.5
    cy = (h - 1) * 0.5
    tx = translate_xy[..., 0, None, None]
    ty = translate_xy[..., 1, None, None]
    dev = angle_deg.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    dx = xs - cx - tx
    dy = ys - cy - ty
    src_x = (ia * dx + ib * dy) / scale + cx
    src_y = (ic * dx + id_ * dy) / scale + cy
    return src_y, src_x


def bilinear_sample(frames: torch.Tensor, src_y: torch.Tensor,
                    src_x: torch.Tensor) -> torch.Tensor:
    """frames [B, T, H, W, C], grids [B, H', W'] → [B, T, H', W', C]; zero
    outside the frame."""
    B, T, h, w, _ = frames.shape
    y0 = torch.floor(src_y)
    x0 = torch.floor(src_x)
    wy = (src_y - y0)[:, None, ..., None]
    wx = (src_x - x0)[:, None, ..., None]
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    bi = torch.arange(B, device=frames.device)[:, None, None, None]
    ti = torch.arange(T, device=frames.device)[None, :, None, None]

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = frames[bi, ti, yi.clamp(0, h - 1)[:, None],
                      xi.clamp(0, w - 1)[:, None]]
        return torch.where(valid[:, None, ..., None], vals,
                           torch.zeros((), dtype=vals.dtype, device=vals.device))

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def affine_warp_clip(frames: torch.Tensor, angle_deg, translate_xy, scale,
                     shear_deg) -> torch.Tensor:
    """[B, T, H, W, C] → warped, one map per clip: direct bilinear sampling,
    four taps per output pixel by gather (the exact torchvision filter)."""
    _, _, h, w, _ = frames.shape
    src_y, src_x = affine_grid(h, w, angle_deg, translate_xy, scale,
                               shear_deg)
    return bilinear_sample(frames, src_y, src_x)


def _inverse_coeffs(h, w, angle_deg, translate_xy, scale, shear_deg):
    """src_x = m00·x + m01·y + ox ; src_y = m10·x + m11·y + oy (the inverse
    map of ``affine_grid`` in explicit coefficient form), each [...]."""
    ia, ib, ic, id_ = _coeffs(angle_deg, shear_deg)
    cx = (w - 1) * 0.5
    cy = (h - 1) * 0.5
    tx, ty = translate_xy[..., 0], translate_xy[..., 1]
    m00, m01 = ia / scale, ib / scale
    m10, m11 = ic / scale, id_ / scale
    ox = cx - (ia * (cx + tx) + ib * (cy + ty)) / scale
    oy = cy - (ic * (cx + tx) + id_ * (cy + ty)) / scale
    return (m00, m01, ox), (m10, m11, oy)


def _band_weights(coords: torch.Tensor, n_in: int) -> torch.Tensor:
    """[...] fractional source coordinates → [..., n_in] bilinear tap
    weights in bf16 (triangle kernel, at most two nonzero per row, zero
    fill out of bounds)."""
    xi = torch.arange(n_in, dtype=torch.float32, device=coords.device)
    wgt = (1.0 - (coords[..., None] - xi).abs()).clamp_min(0.0)
    return wgt.to(torch.bfloat16)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b of bf16 operands with a float32 result."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def separable_coeffs(h: int, w: int, angle_deg, translate_xy, scale,
                     shear_deg):
    """(δ, ε, ζ, m10, m11, oy), each [...]: the two passes' coefficients of
    ``affine_warp_clip_separable`` (its docstring gives the factoring)."""
    angle_deg, scale, shear_deg = (torch.as_tensor(v, dtype=torch.float32)
                                   for v in (angle_deg, scale, shear_deg))
    translate_xy = torch.as_tensor(translate_xy, dtype=torch.float32)
    (m00, m01, ox), (m10, m11, oy) = _inverse_coeffs(
        h, w, angle_deg, translate_xy, scale, shear_deg)
    eps = m01 / m11
    return m00 - eps * m10, eps, ox - eps * oy, m10, m11, oy


def affine_warp_clip_separable(frames: torch.Tensor, angle_deg, translate_xy,
                               scale, shear_deg) -> torch.Tensor:
    """[B, T, H, W, C] → warped by two 1-D resampling passes.

    The inverse map factors (for m11 ≠ 0, |rotation| < 90°) into an x-only
    pass p(x, y) = δx + εy + ζ and a y-only pass
    q(y, x) = m10·x + m11·y + oy, with ε = m01/m11, δ = m00 − ε·m10,
    ζ = ox − ε·oy. Each pass multiplies by a banded bilinear weight matrix.
    Identical to the direct warp for axis-aligned transforms; for rotation
    and shear the two-pass filter samples along the slanted line."""
    B, T, h, w, c = frames.shape
    delta, eps, zeta, m10, m11, oy = separable_coeffs(
        h, w, angle_deg, translate_xy, scale, shear_deg)
    col = lambda v: v[:, None, None]  # noqa: E731  [B] → [B, 1, 1]

    dev = frames.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    # pass 1, along x at integer rows: tmp[b, t, y, o, c]
    p = col(delta) * xs[None, None, :] + col(eps) * ys[None, :, None] + col(zeta)
    wx = _band_weights(p, w)                                  # [B, H, Wo, Wi]
    src = frames.to(torch.bfloat16).permute(0, 2, 3, 1, 4)    # [B, H, Wi, T, C]
    tmp = _bmm_f32(wx.reshape(B * h, w, w), src.reshape(B * h, w, T * c))
    tmp = tmp.reshape(B, h, w, T, c)                          # [B, Hi, x, T, C]
    # pass 2, along y in each column: out[b, t, j, x, c]
    q = col(m10) * xs[None, None, :] + col(m11) * ys[None, :, None] + col(oy)
    wy = _band_weights(q.transpose(1, 2), h)                  # [B, W, Ho, Hi]
    src = tmp.to(torch.bfloat16).permute(0, 2, 1, 3, 4)       # [B, x, Hi, T, C]
    out = _bmm_f32(wy.reshape(B * w, h, h), src.reshape(B * w, h, T * c))
    out = out.reshape(B, w, h, T, c).permute(0, 3, 2, 1, 4)   # [B, T, Ho, W, C]
    return out.to(frames.dtype)
