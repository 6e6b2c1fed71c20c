"""Per-clip video augmentation on the device.

Counterpart of ``vision_collision_detection_tpu/ops/augment.py``. Each clip
draws its parameters once (``sample_clip_params``) and applies them to all
of its frames, in the reference order: color (brightness → contrast →
saturation → hue) → affine → grayscale → noise → blur → posterize →
solarize → invert → cutout; a per-clip skip gate keeps the untouched clip.

Draws come from the ``torch.Generator`` the caller passes in, with the
JAX package's laws and ranges; the two packages' generators give different
draws, so the tests hand JAX-sampled parameters to both ``augment_clip``s.
The work is batched over clips: parameters carry a leading clip dimension
and broadcast against [B, T, H, W, C].
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from vision_collision_detection_tpu_torch.config import AugmentConfig
from vision_collision_detection_tpu_torch.ops import color as C
from vision_collision_detection_tpu_torch.ops.affine import (
    affine_warp_clip,
    affine_warp_clip_separable,
)


def sample_clip_params(generator: torch.Generator, cfg: AugmentConfig,
                       h: int, w: int, batch: Optional[int] = None) -> Dict:
    """One clip's augmentation parameters (``batch`` None: 0-d tensors; the
    cutout boxes [k_max]) or ``batch`` clips' (a leading [batch]), on the
    generator's device. Every decision draws on its own."""
    lead = () if batch is None else (int(batch),)
    dev = generator.device

    def rand(*shape):
        return torch.rand(lead + shape, generator=generator, device=dev)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * rand(*shape)

    def randint(lo, hi):  # [lo, hi]
        return torch.randint(int(lo), int(hi) + 1, lead, generator=generator,
                             device=dev)

    k_max = int(cfg.cutout_count_range[1])
    size_f = uniform(*cfg.cutout_size_range, k_max)
    cut_h = torch.floor(h * size_f).to(torch.int32)
    cut_w = torch.floor(w * size_f).to(torch.int32)
    max_top = (h - cut_h - 1).clamp_min(0)
    max_left = (w - cut_w - 1).clamp_min(0)
    t_max = float(cfg.translate_range[1])
    return {
        "skip": rand() > cfg.aug_probability,
        "brightness": uniform(*cfg.brightness_range),
        "contrast": uniform(*cfg.contrast_range),
        "saturation": uniform(*cfg.saturation_range),
        "hue": uniform(*cfg.hue_range),
        "rotation": uniform(*cfg.rotation_range),
        "scale": uniform(*cfg.scale_range),
        "shear": uniform(*cfg.shear_range),
        # the translation's sign is drawn over the full ±max range
        "translate": torch.stack([uniform(-t_max, t_max) * w,
                                  uniform(-t_max, t_max) * h], dim=-1),
        "grayscale": rand() < cfg.grayscale_prob,
        "cutout": rand() < cfg.cutout_prob,
        "cutout_count": randint(*cfg.cutout_count_range),
        "cutout_h": cut_h,
        "cutout_w": cut_w,
        "cutout_top": torch.floor(rand(k_max) * (max_top + 1).float()
                                  ).to(torch.int32),
        "cutout_left": torch.floor(rand(k_max) * (max_left + 1).float()
                                   ).to(torch.int32),
        "invert": rand() < cfg.color_inversion_prob,
        "solarize": rand() < cfg.solarization_prob,
        "posterize": rand() < cfg.posterization_prob,
        "posterize_bits": randint(*cfg.posterization_bits_range),
    }


def _gaussian_kernel(sigma: float, device) -> torch.Tensor:
    half = int(sigma * 4)  # the reference's kernel-size formula
    xs = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    return k / k.sum()


def _reflect_index(n: int, half: int, device) -> torch.Tensor:
    """Indices of an axis of length n padded by ``half`` on each side with
    reflection (the edge not repeated), as ``jnp.pad(mode="reflect")``."""
    i = torch.arange(-half, n + half, device=device).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def gaussian_blur_clip(frames: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur over [..., H, W, C] with reflect padding:
    a weighted sum of shifted copies along H, then along W, in the frames'
    dtype."""
    if sigma <= 0:
        return frames
    k1d = _gaussian_kernel(sigma, frames.device).to(frames.dtype)
    ksize = k1d.shape[0]
    half = ksize // 2
    h, w = frames.shape[-3], frames.shape[-2]
    x = frames.index_select(-3, _reflect_index(h, half, frames.device))
    y = sum(k1d[k] * x[..., k:k + h, :, :] for k in range(ksize))
    x = y.index_select(-2, _reflect_index(w, half, frames.device))
    return sum(k1d[k] * x[..., k:k + w, :] for k in range(ksize))


def _cutout_mask(h: int, w: int, params: Dict) -> torch.Tensor:
    """[B, H, W] multiplicative mask, zero inside the active boxes."""
    top = params["cutout_top"][..., None, None]
    left = params["cutout_left"][..., None, None]
    ch = params["cutout_h"][..., None, None]
    cw = params["cutout_w"][..., None, None]
    dev = top.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    k_max = params["cutout_top"].shape[-1]
    active = params["cutout"][..., None] & (
        torch.arange(k_max, device=dev) < params["cutout_count"][..., None])
    inside = (ys >= top) & (ys < top + ch) & (xs >= left) & (xs < left + cw)
    hit = (inside & active[..., None, None]).any(dim=-3)
    return torch.where(hit, 0.0, 1.0)


def apply_clip_params(frames: torch.Tensor, params: Dict,
                      cfg: AugmentConfig,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """[B, T, H, W, C] float in [0, 1] → augmented, clip b with the b-th
    entry of each parameter. ``generator`` draws the noise when
    ``cfg.noise_level`` > 0."""
    B, _, h, w, _ = frames.shape

    def per_clip(v):  # [B] → [B, 1, 1, 1, 1]
        return v.reshape(B, 1, 1, 1, 1)

    x = frames
    x = C.adjust_brightness(x, per_clip(params["brightness"]))
    x = C.adjust_contrast(x, per_clip(params["contrast"]))
    x = C.adjust_saturation(x, per_clip(params["saturation"]))
    x = C.adjust_hue(x, params["hue"].reshape(B, 1, 1, 1))

    warp = (affine_warp_clip_separable if cfg.affine_mode == "separable"
            else affine_warp_clip)
    x = warp(x, params["rotation"], params["translate"], params["scale"],
             params["shear"])

    x = torch.where(per_clip(params["grayscale"]), C.rgb_to_grayscale(x), x)

    # noise: unconditional when configured, fresh per frame
    if cfg.noise_level > 0:
        if generator is None:
            raise ValueError("noise_level > 0 draws noise from a generator; "
                             "pass generator=")
        noise = torch.randn(x.shape, generator=generator,
                            device=generator.device) * cfg.noise_level
        x = (x + noise).clamp(0.0, 1.0)

    # blur: unconditional when configured, a static kernel
    if cfg.blur_sigma > 0:
        x = gaussian_blur_clip(x, cfg.blur_sigma)

    if cfg.posterization_prob > 0:
        x = torch.where(per_clip(params["posterize"]),
                        C.posterize(x, per_clip(params["posterize_bits"])), x)
    if cfg.solarization_prob > 0:
        x = torch.where(per_clip(params["solarize"]),
                        C.solarize(x, cfg.solarization_threshold), x)
    if cfg.color_inversion_prob > 0:
        x = torch.where(per_clip(params["invert"]), C.invert(x), x)

    if cfg.cutout_prob > 0:
        x = x * _cutout_mask(h, w, params)[:, None, :, :, None]

    # the per-clip skip gate
    return torch.where(per_clip(params["skip"]), frames, x)


def augment_clip(frames: torch.Tensor, params: Dict, cfg: AugmentConfig,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[T, H, W, C] float in [0, 1] → augmented with one clip's parameters
    (as ``sample_clip_params`` gives them with ``batch=None``)."""
    batched = {k: torch.as_tensor(v, device=frames.device)[None]
               for k, v in params.items()}
    return apply_clip_params(frames[None], batched, cfg, generator)[0]


def augment_batch(generator: torch.Generator, frames: torch.Tensor,
                  cfg: AugmentConfig) -> torch.Tensor:
    """[B, T, H, W, C] float in [0, 1] → augmented, each clip with its own
    parameters drawn from ``generator``."""
    B, _, h, w, _ = frames.shape
    params = sample_clip_params(generator, cfg, h, w, batch=B)
    return apply_clip_params(frames, params, cfg, generator)
