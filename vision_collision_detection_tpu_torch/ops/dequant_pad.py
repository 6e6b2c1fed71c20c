"""K1: uint8 letterbox-content frames → normalised, padded frames.

Replaces the TPU kernel ``vision_collision_detection_tpu/ops/pallas_ops.py``
``fused_dequant_normalize_pad``. The CUDA kernel is
``ops/csrc/dequant_pad.cu`` and writes bf16 or float32, as the model's
compute dtype asks. Its bound on the H100 is bytes (one read of the content,
one write of the frame: at N=200, 126×224 → 224 in bf16 that is 17 MB read
+ 60 MB written, ≈ 23 µs at 3.35 TB/s). It is a row kernel: a warp writes
one output row at a time in 16-byte vectors, a bar row as the repeating
3-channel pattern, a content row from its input bytes staged in shared
memory by 16-byte loads.

Content pixels become ``x · 1/(255·std) + (−mean/std)``, placed at
``((S−ch)//2, (S−cw)//2)``; the bars take ``−mean/std``, the normalised
black. Both versions compute exactly that formula in float32, product
rounded before the sum, then round once to the output dtype, so they agree
bit for bit.
"""

from __future__ import annotations

import torch

from vision_collision_detection_tpu_torch.ops import _build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _affine(mean, std):
    a = [1.0 / (255.0 * float(s)) for s in std]
    b = [-float(m) / float(s) for m, s in zip(mean, std)]
    return a, b


def _check_shape(frames_u8: torch.Tensor, target_size: int):
    *lead, ch, cw, c = frames_u8.shape
    if c != 3:
        raise ValueError(f"expected packed RGB, got {c} channels")
    if frames_u8.dtype != torch.uint8:
        raise ValueError(f"expected uint8 frames, got {frames_u8.dtype}")
    S = int(target_size)
    if ch > S or cw > S:
        raise ValueError(f"content {ch}x{cw} exceeds target {S}")
    return lead, ch, cw, S


def dequant_normalize_pad_plain(frames_u8: torch.Tensor, target_size: int,
                                mean, std,
                                out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K1: [..., ch, cw, 3] uint8 → [..., S, S, 3]
    in ``out_dtype``."""
    lead, ch, cw, S = _check_shape(frames_u8, target_size)
    a, b = _affine(mean, std)
    dev = frames_u8.device
    a_t = torch.tensor(a, dtype=torch.float32, device=dev)
    b_t = torch.tensor(b, dtype=torch.float32, device=dev)
    y = frames_u8.to(torch.float32) * a_t + b_t
    out = b_t.expand(*lead, S, S, 3).clone()
    ph, pw = (S - ch) // 2, (S - cw) // 2
    out[..., ph:ph + ch, pw:pw + cw, :] = y
    return out.to(out_dtype)


def dequant_normalize_pad(frames_u8: torch.Tensor, target_size: int,
                          mean, std, out_dtype=torch.bfloat16) -> torch.Tensor:
    """K1. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel, which writes bf16 or float32 and raises for another
    ``out_dtype``. Returns a contiguous [..., S, S, 3] tensor, so
    ``.permute(0, 3, 1, 2)`` of a frame batch is a channels_last NCHW view.
    The call is the op ``vcd::dequant_pad`` (``ops/library.py``), whose
    implementation is ``_run``, so that ``torch.export`` can trace it."""
    _check_shape(frames_u8, target_size)
    from vision_collision_detection_tpu_torch.ops import library

    return library.dequant_pad(frames_u8, int(target_size),
                               [float(m) for m in mean],
                               [float(s) for s in std], out_dtype)


def _run(frames_u8: torch.Tensor, target_size: int, mean, std,
         out_dtype) -> torch.Tensor:
    """K1 on a real tensor: the plain version on the CPU, the kernel on
    the card."""
    if frames_u8.device.type == "cpu":
        return dequant_normalize_pad_plain(frames_u8, target_size, mean, std,
                                           out_dtype)
    lead, ch, cw, S = _check_shape(frames_u8, target_size)
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(
            f"dequant_normalize_pad kernel writes bf16 or float32, got "
            f"{out_dtype}")
    _build.require_cuda(frames_u8, "frames_u8")
    n = 1
    for d in lead:
        n *= int(d)
    a, b = _affine(mean, std)
    out = torch.empty(*lead, S, S, 3, dtype=out_dtype,
                      device=frames_u8.device)
    err = _build.lib().vcd_dequant_pad(
        frames_u8.data_ptr(), out.data_ptr(), n, ch, cw, S, *a, *b,
        _DTYPE_CODE[out_dtype], _build.stream_ptr(frames_u8.device))
    _build.check(err, "vcd_dequant_pad")
    dequant_normalize_pad.launches += 1
    return out


dequant_normalize_pad.launches = 0
