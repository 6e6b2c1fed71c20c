"""K2: depthwise 7×7 convolution, stride 1, SAME, + bias, NHWC (forward).

Replaces the TPU kernel ``vision_collision_detection_tpu/ops/dwconv_pallas.py``
``dwconv7x7`` (``_run_fwd``, ``_fwd_kernel``). The CUDA kernel is
``ops/csrc/dwconv.cu``; it masks the 3-pixel halo while loading its tile
instead of padding the input in device memory. Its bound on the H100 is
operations: each of the flagship forward's 18 launches reads x and writes y
once (≈ 1.7 GB over the 18 at B=8, ≈ 0.51 ms at 3.35 TB/s), but its 98
float32 flops per output (≈ 42 GFLOP over the 18) take ≈ 0.63 ms on the
CUDA cores at 67 TFLOP/s.

Weights come as ``[49, C]`` (tap ``dy*7 + dx`` major), the TPU kernel's
layout. Accumulation is float32 whatever the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vision_collision_detection_tpu_torch.ops import _build

K = 7
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    if x.dim() != 4:
        raise ValueError(f"expected NHWC x, got shape {tuple(x.shape)}")
    C = x.shape[-1]
    if tuple(w.shape) != (K * K, C) or tuple(b.shape) != (C,):
        raise ValueError(
            f"w must be [49, {C}] and b [{C}], got {tuple(w.shape)}, "
            f"{tuple(b.shape)}")
    if w.dtype != x.dtype or b.dtype != x.dtype:
        raise ValueError(f"x, w, b dtypes differ: {x.dtype}, {w.dtype}, {b.dtype}")


def dwconv7x7_plain(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: ``F.conv2d(groups=C)`` on float32-cast
    inputs, cast back to x's dtype. x [N,H,W,C], w [49,C], b [C]."""
    _check(x, w, b)
    C = x.shape[-1]
    weight = w.to(torch.float32).t().reshape(C, 1, K, K)
    y = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2), weight,
                 b.to(torch.float32), padding=K // 2, groups=C)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def dwconv7x7(x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """K2. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (bf16 or float32, C even, all contiguous)."""
    if x.device.type == "cpu":
        return dwconv7x7_plain(x, w, b)
    _check(x, w, b)
    # channel pairs are read and written as one value of twice the size
    for t, name in ((x, "x"), (w, "w"), (b, "b")):
        _build.require_cuda(t, name, align=2 * x.element_size())
    N, H, W, C = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"dwconv7x7 kernel takes bf16 or float32, got {x.dtype}")
    if C % 2:
        raise ValueError(f"dwconv7x7 kernel needs an even channel count, got {C}")
    out = torch.empty_like(x)
    err = _build.lib().vcd_dwconv7x7(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        N, H, W, C, _DTYPE_CODE[x.dtype], _build.stream_ptr(x.device))
    _build.check(err, "vcd_dwconv7x7")
    dwconv7x7.launches += 1
    return out


dwconv7x7.launches = 0
