"""The training preprocess as one hand-written CUDA pass.

``train_preprocess`` (``ops/preprocess.py``) is a chain of plain torch ops,
as the JAX package leaves it to XLA; on the card that chain is about a
hundred launches with every intermediate in float32. For the inputs that
``route`` picks, this module computes the same function in two launches of
``ops/csrc/train_preprocess.cu`` (it replaces no TPU kernel: the JAX package
has none here). The chain stays as its plain version: every other input
takes it, and the card tests hold the kernel against it.

The draws are the chain's, from the same generator in the same order (the
flips, then ``sample_clip_params`` at the letterboxed size), so a seed gives
the same flips, parameters and frames on both routes. They stay on the
device: ``draw_table`` packs them, with the warp's coefficients computed by
the chain's own torch ops, into one float32 table [B, columns] that the
kernel reads. Nothing is read back to the host.
"""

from __future__ import annotations

import torch

from vision_collision_detection_tpu_torch.config import AugmentConfig
from vision_collision_detection_tpu_torch.ops import _build
from vision_collision_detection_tpu_torch.ops.affine import (
    _coeffs,
    separable_coeffs,
)
from vision_collision_detection_tpu_torch.ops.augment import sample_clip_params

# the chain's warps: "separable", and the gather warp for any other name
WARP_MODES = ("separable", "gather")
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

# Columns of the table, one row a clip; ``ops/csrc/train_preprocess.cu``
# reads the same (``Col``). Gates and counts are 0/1 and small whole numbers
# in float32. WARP holds 8 slots: separable δ, ε, ζ, m10, m11, oy (the two
# passes' coefficients); gather ia, ib, ic, id, scale, tx, ty (the inverse
# map of ``affine_grid``). BOXES holds (top, left, h, w) for each of the
# k_max cutout boxes, of which the first CUTS are active.
(FLIP, SKIP, BRIGHTNESS, CONTRAST, SATURATION, HUE, GRAYSCALE, POSTERIZE,
 POSTERIZE_BITS, SOLARIZE, INVERT, CUTS) = range(12)
WARP = 12
BOXES = WARP + 8


def columns(cfg: AugmentConfig) -> int:
    return BOXES + 4 * int(cfg.cutout_count_range[1])


def route(shape, dtype, device_type: str, cfg: AugmentConfig,
          target_size: int) -> str:
    """``"fused"`` for uint8 letterbox content [B, T, h, w, 3] on the card
    (h, w ≤ S, one of them S: K1's test) under a configuration whose every
    step is computed pixel by pixel (no noise, no blur); ``"plain"`` (the
    chain) for everything else."""
    S = int(target_size)
    content_sized = (len(shape) == 5 and shape[-1] == 3
                     and shape[-3] <= S and shape[-2] <= S
                     and S in (shape[-3], shape[-2]))
    pixelwise = cfg.noise_level == 0 and cfg.blur_sigma == 0
    fused = (device_type == "cuda" and dtype == torch.uint8 and content_sized
             and pixelwise)
    return "fused" if fused else "plain"


def draw_table(generator: torch.Generator, batch: int, cfg: AugmentConfig,
               target_size: int) -> torch.Tensor:
    """The chain's draws for ``batch`` clips, in its order (the flips, then
    ``sample_clip_params`` at the letterboxed size), packed into float32
    [batch, ``columns(cfg)``] on the generator's device. With augmentation
    off no parameter is drawn and every clip takes the skip gate's
    untouched frames."""
    S = int(target_size)
    dev = generator.device
    f32 = lambda v: v.to(torch.float32)  # noqa: E731
    zeros = torch.zeros(batch, dtype=torch.float32, device=dev)
    flips = zeros
    if cfg.horizontal_flip_prob > 0:
        flips = f32(torch.rand((batch, 1, 1, 1, 1), generator=generator,
                               device=dev) < cfg.horizontal_flip_prob
                    ).reshape(batch)
    if not cfg.enabled:
        table = torch.zeros(batch, columns(cfg), dtype=torch.float32,
                            device=dev)
        table[:, FLIP] = flips
        table[:, SKIP] = 1.0
        return table
    p = sample_clip_params(generator, cfg, S, S, batch=batch)
    if cfg.affine_mode == "separable":
        warp = list(separable_coeffs(S, S, p["rotation"], p["translate"],
                                     p["scale"], p["shear"])) + [zeros, zeros]
    else:
        warp = list(_coeffs(p["rotation"], p["shear"])) + [
            p["scale"], p["translate"][:, 0], p["translate"][:, 1], zeros]
    cuts = torch.where(p["cutout"], p["cutout_count"], 0)
    boxes = torch.stack([p["cutout_top"], p["cutout_left"], p["cutout_h"],
                         p["cutout_w"]], dim=-1).reshape(batch, -1)
    head = torch.stack(
        [flips, f32(p["skip"]), p["brightness"], p["contrast"],
         p["saturation"], p["hue"], f32(p["grayscale"]), f32(p["posterize"]),
         f32(p["posterize_bits"]), f32(p["solarize"]), f32(p["invert"]),
         f32(cuts)] + warp, dim=1)
    return torch.cat([head, f32(boxes)], dim=1)


def _check(generator: torch.Generator, frames_u8: torch.Tensor,
           cfg: AugmentConfig, target_size: int, out_dtype) -> None:
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"the fused training preprocess writes bf16 or "
                         f"float32, got {out_dtype}")
    if route(tuple(frames_u8.shape), frames_u8.dtype,
             frames_u8.device.type, cfg, target_size) != "fused":
        raise ValueError(
            f"the fused training preprocess takes uint8 letterbox content "
            f"[B, T, h, w, 3] on the card with noise and blur off; got "
            f"{frames_u8.dtype} {tuple(frames_u8.shape)} on "
            f"{frames_u8.device}, S={target_size}, noise_level="
            f"{cfg.noise_level}, blur_sigma={cfg.blur_sigma}")


def fused_train_preprocess(generator: torch.Generator, frames_u8: torch.Tensor,
                           cfg: AugmentConfig, target_size: int,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """``train_preprocess`` by the kernel: uint8 [B, T, h, w, 3] on the card
    → normalised [B, T, S, S, 3] in ``out_dtype``, drawing from
    ``generator`` as the chain does. Raises for input that ``route`` does
    not send here."""
    _check(generator, frames_u8, cfg, target_size, out_dtype)
    frames_u8 = frames_u8.contiguous()
    B, T = frames_u8.shape[:2]
    S = int(target_size)
    dev = frames_u8.device
    table = draw_table(generator, B, cfg, S)
    if table.device != dev:
        raise ValueError(f"the generator drew on {table.device}, the frames "
                         f"are on {dev}")
    means = torch.empty(B * T, dtype=torch.float32, device=dev)
    out = torch.empty(B, T, S, S, 3, dtype=out_dtype, device=dev)
    _launch(frames_u8, table, means, out, cfg, int(cfg.enabled))
    return out


fused_train_preprocess.launches = 0


def _launch(frames_u8: torch.Tensor, table: torch.Tensor, means: torch.Tensor,
            out: torch.Tensor, cfg: AugmentConfig, augment: int) -> None:
    """The C entry on contiguous uint8 content [B, T, h, w, 3], ``table``
    [B, ``columns(cfg)``], ``means`` [B·T] and ``out`` [B, T, S, S, 3]
    (bf16 or float32): with ``augment`` the contrast means, then the
    frames, else the frames alone (every clip's skip gate). Counts each
    kernel it launches on ``fused_train_preprocess.launches``."""
    B, T, ch, cw, _ = frames_u8.shape
    err = _build.lib().vcd_train_preprocess(
        frames_u8.data_ptr(), table.data_ptr(), means.data_ptr(),
        out.data_ptr(), B, T, ch, cw, out.shape[2], columns(cfg),
        int(cfg.affine_mode != "separable"), int(augment),
        *[float(m) for m in cfg.normalize_mean],
        *[float(s) for s in cfg.normalize_std],
        float(cfg.solarization_threshold), _DTYPE_CODE[out.dtype],
        _build.stream_ptr(out.device))
    _build.check(err, "vcd_train_preprocess")
    fused_train_preprocess.launches += 2 if augment else 1
