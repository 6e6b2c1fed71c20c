"""Preprocessing: uint8 decode output → model-ready frames.

Counterpart of ``vision_collision_detection_tpu/ops/preprocess.py``:
``eval_preprocess`` (letterbox and normalise; when the decoder shipped only
the letterbox content rows, the whole op is the K1 kernel,
``ops/dequant_pad.py``) and ``train_preprocess`` (flip, letterbox,
per-clip augmentation, normalise: one fused kernel on the card where
``fused_preprocess.route`` allows, ``ops/fused_preprocess.py``; else plain
torch ops, as the JAX package leaves them to XLA).
"""

from __future__ import annotations

import torch

from vision_collision_detection_tpu_torch.config import AugmentConfig
from vision_collision_detection_tpu_torch.ops import fused_preprocess
from vision_collision_detection_tpu_torch.ops.augment import augment_batch
from vision_collision_detection_tpu_torch.ops.dequant_pad import (
    dequant_normalize_pad,
)
from vision_collision_detection_tpu_torch.ops.letterbox import letterbox_resize

USE_KERNEL = ("auto", "never", "force")


def normalize_video(x: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def train_preprocess(generator: torch.Generator, frames_u8: torch.Tensor,
                     cfg: AugmentConfig, target_size: int,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 [B, T, H, W, 3] → normalised [B, T, S, S, 3] in ``out_dtype``:
    a horizontal flip per clip (on the uint8 tensor when its width is
    already S, the same result at a quarter of the bytes), letterbox,
    augmentation when ``cfg.enabled``, normalisation. Every draw comes
    from ``generator``, on the frames' device: the flips first, then the
    clips' parameters.

    Input that ``fused_preprocess.route`` sends to the kernel (uint8
    letterbox content on the card, no noise, no blur) takes it, whose
    launches count on ``fused_preprocess.fused_train_preprocess.launches``;
    the rest takes the chain, ``train_preprocess_plain``, whose calls on
    the card count on ``train_preprocess.plain_cuda_calls``."""
    if fused_preprocess.route(tuple(frames_u8.shape), frames_u8.dtype,
                              frames_u8.device.type, cfg,
                              target_size) == "fused":
        return fused_preprocess.fused_train_preprocess(
            generator, frames_u8, cfg, target_size, out_dtype)
    if frames_u8.is_cuda:
        train_preprocess.plain_cuda_calls += 1
    return train_preprocess_plain(generator, frames_u8, cfg, target_size,
                                  out_dtype)


train_preprocess.plain_cuda_calls = 0


def train_preprocess_plain(generator: torch.Generator, frames_u8: torch.Tensor,
                           cfg: AugmentConfig, target_size: int,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """``train_preprocess`` as a chain of torch ops on any device: the fused
    kernel's plain version."""
    b = frames_u8.shape[0]
    flip = None
    if cfg.horizontal_flip_prob > 0:
        flip = torch.rand((b, 1, 1, 1, 1), generator=generator,
                          device=generator.device) < cfg.horizontal_flip_prob
    flip_u8 = flip is not None and frames_u8.shape[-2] == target_size
    if flip_u8:
        frames_u8 = torch.where(flip, frames_u8.flip(-2), frames_u8)
    x = frames_u8.to(torch.float32) / 255.0
    x = letterbox_resize(x, target_size)
    if flip is not None and not flip_u8:
        x = torch.where(flip, x.flip(-2), x)
    if cfg.enabled:
        x = augment_batch(generator, x, cfg)
    x = normalize_video(x, cfg.normalize_mean, cfg.normalize_std)
    return x.to(out_dtype)


def eval_preprocess(frames_u8: torch.Tensor, cfg: AugmentConfig,
                    target_size: int, out_dtype=torch.bfloat16,
                    use_kernel: str = "auto") -> torch.Tensor:
    """uint8 [..., H, W, 3] → normalised [..., S, S, 3] in ``out_dtype``.

    use_kernel: "auto" runs K1 for a content-sized uint8 CUDA tensor (K1
    raises for an ``out_dtype`` it does not write); "force" runs
    ``dequant_normalize_pad`` whenever the input is content-sized (its plain
    version on a CPU tensor); "never" takes the letterbox-resize path below.
    """
    if use_kernel not in USE_KERNEL:
        raise ValueError(f"use_kernel {use_kernel!r} not in {USE_KERNEL}")
    h, w = frames_u8.shape[-3], frames_u8.shape[-2]
    content_sized = (
        frames_u8.dtype == torch.uint8
        and h <= target_size and w <= target_size
        and (h == target_size or w == target_size)
    )
    use = content_sized and (
        use_kernel == "force"
        or (use_kernel == "auto" and frames_u8.is_cuda))
    if use:
        return dequant_normalize_pad(frames_u8, target_size,
                                     cfg.normalize_mean, cfg.normalize_std,
                                     out_dtype)
    x = frames_u8.to(torch.float32) / 255.0
    x = letterbox_resize(x, target_size)
    x = normalize_video(x, cfg.normalize_mean, cfg.normalize_std)
    return x.to(out_dtype)


def make_train_preprocess(cfg: AugmentConfig, target_size: int,
                          out_dtype=torch.bfloat16):
    """(generator, uint8 frames) → ``train_preprocess`` with these settings."""
    return lambda generator, frames: train_preprocess(
        generator, frames, cfg, target_size, out_dtype)


def make_eval_preprocess(cfg: AugmentConfig, target_size: int,
                         out_dtype=torch.bfloat16):
    """uint8 frames → ``eval_preprocess`` with these settings."""
    return lambda frames: eval_preprocess(frames, cfg, target_size, out_dtype)
