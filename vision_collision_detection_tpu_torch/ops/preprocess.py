"""Eval preprocessing: uint8 decode output → model-ready frames.

Counterpart of ``vision_collision_detection_tpu/ops/preprocess.py``
(``normalize_video``, ``eval_preprocess``). When the decoder shipped only
the letterbox content rows, the whole op is the K1 kernel
(``ops/dequant_pad.py``).
"""

from __future__ import annotations

import torch

from vision_collision_detection_tpu_torch.config import AugmentConfig
from vision_collision_detection_tpu_torch.ops.dequant_pad import (
    dequant_normalize_pad,
)
from vision_collision_detection_tpu_torch.ops.letterbox import letterbox_resize

USE_KERNEL = ("auto", "never", "force")


def normalize_video(x: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


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
