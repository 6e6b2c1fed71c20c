"""EfficientNetV2 S/M/L frame backbones (NHWC).

Counterpart of ``vision_collision_detection_tpu/models/backbones/efficientnet.py``:
Fused-MBConv early stages and squeeze-excite MBConv later ones, with the JAX
module tree (``stem_conv``/``stem_bn``, ``block{i}``, ``head_conv``/
``head_bn``). SiLU activations; flax's BatchNorm (``models/norm.py``) with
momentum 0.9 and eps 1e-3. The JAX blocks have no stochastic depth, so
neither do these.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vision_collision_detection_tpu_torch.models.backbones import (
    BACKBONE_REGISTRY,
)
from vision_collision_detection_tpu_torch.models.backbones.convnext import (
    conv_nhwc,
)
from vision_collision_detection_tpu_torch.models.backbones.mobilenet import (
    SqueezeExcite,
)
from vision_collision_detection_tpu_torch.models.backbones.resnet import (
    global_mean,
)
from vision_collision_detection_tpu_torch.models.norm import BatchNorm


def _conv(cin, cout, k, stride=1, groups=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     groups=groups, bias=False)


def _bn(c, dtype):
    return BatchNorm(c, momentum=0.9, eps=1e-3, dtype=dtype)


class FusedMBConv(nn.Module):
    """expand ≠ 1: k×k expand (strided) → SiLU → 1×1 project; expand = 1:
    one k×k conv → BN → SiLU. The residual where stride is 1 and the widths
    agree."""

    def __init__(self, cin: int, out_ch: int, expand: int, kernel: int = 3,
                 strides: int = 1, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.residual = strides == 1 and cin == out_ch
        if expand != 1:
            exp_ch = cin * expand
            self.expand_conv = _conv(cin, exp_ch, kernel, strides)
            self.expand_bn = _bn(exp_ch, dtype)
            self.project_conv = _conv(exp_ch, out_ch, 1)
        else:
            self.project_conv = _conv(cin, out_ch, kernel, strides)
        self.project_bn = _bn(out_ch, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if hasattr(self, "expand_conv"):
            y = F.silu(self.expand_bn(conv_nhwc(x, self.expand_conv, dt)))
            y = self.project_bn(conv_nhwc(y, self.project_conv, dt))
        else:
            y = F.silu(self.project_bn(conv_nhwc(x, self.project_conv, dt)))
        return y + x if self.residual else y


class MBConvSE(nn.Module):
    """1×1 expand → SiLU → depthwise k×k (strided) → SiLU → SE (sigmoid
    gate, squeeze to a quarter of the input width) → 1×1 project."""

    def __init__(self, cin: int, out_ch: int, expand: int, kernel: int = 3,
                 strides: int = 1, se_ratio: float = 0.25,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.residual = strides == 1 and cin == out_ch
        exp_ch = cin * expand
        self.expand_conv = _conv(cin, exp_ch, 1)
        self.expand_bn = _bn(exp_ch, dtype)
        self.dw_conv = _conv(exp_ch, exp_ch, kernel, strides, groups=exp_ch)
        self.dw_bn = _bn(exp_ch, dtype)
        self.se = SqueezeExcite(exp_ch, max(1, int(cin * se_ratio)),
                                gate=torch.sigmoid, dtype=dtype)
        self.project_conv = _conv(exp_ch, out_ch, 1)
        self.project_bn = _bn(out_ch, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.silu(self.expand_bn(conv_nhwc(x, self.expand_conv, dt)))
        y = F.silu(self.dw_bn(conv_nhwc(y, self.dw_conv, dt)))
        y = self.se(y)
        y = self.project_bn(conv_nhwc(y, self.project_conv, dt))
        return y + x if self.residual else y


# rows: (block_kind, expand, kernel, stride, out_ch, repeats)
_V2_S = (24, (
    ("fused", 1, 3, 1, 24, 2),
    ("fused", 4, 3, 2, 48, 4),
    ("fused", 4, 3, 2, 64, 4),
    ("mbconv", 4, 3, 2, 128, 6),
    ("mbconv", 6, 3, 1, 160, 9),
    ("mbconv", 6, 3, 2, 256, 15),
))
_V2_M = (24, (
    ("fused", 1, 3, 1, 24, 3),
    ("fused", 4, 3, 2, 48, 5),
    ("fused", 4, 3, 2, 80, 5),
    ("mbconv", 4, 3, 2, 160, 7),
    ("mbconv", 6, 3, 1, 176, 14),
    ("mbconv", 6, 3, 2, 304, 18),
    ("mbconv", 6, 3, 1, 512, 5),
))
_V2_L = (32, (
    ("fused", 1, 3, 1, 32, 4),
    ("fused", 4, 3, 2, 64, 7),
    ("fused", 4, 3, 2, 96, 7),
    ("mbconv", 4, 3, 2, 192, 10),
    ("mbconv", 6, 3, 1, 224, 19),
    ("mbconv", 6, 3, 2, 384, 25),
    ("mbconv", 6, 3, 1, 640, 7),
))


class EfficientNetV2(nn.Module):
    def __init__(self, stem_ch: int, table: Sequence[Tuple],
                 head_ch: int = 1280, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem_conv = _conv(3, stem_ch, 3, 2)
        self.stem_bn = _bn(stem_ch, dtype)
        cin, idx = stem_ch, 0
        for kind, expand, kernel, stride, out_ch, repeats in table:
            cls = FusedMBConv if kind == "fused" else MBConvSE
            for i in range(repeats):
                self.add_module(f"block{idx}", cls(
                    cin, out_ch, expand, kernel=kernel,
                    strides=stride if i == 0 else 1, dtype=dtype))
                cin, idx = out_ch, idx + 1
        self.num_blocks = idx
        self.head_conv = _conv(cin, head_ch, 1)
        self.head_bn = _bn(head_ch, dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        x = F.silu(self.stem_bn(conv_nhwc(x, self.stem_conv, dt)))
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        x = F.silu(self.head_bn(conv_nhwc(x, self.head_conv, dt)))
        return global_mean(x, dt)


def _register(name, spec):
    @BACKBONE_REGISTRY.register(name)
    def factory(dtype=None, **kwargs):
        stem, table = spec
        return EfficientNetV2(stem, table, dtype=dtype or torch.bfloat16,
                              **kwargs)
    return factory


efficientnet_v2_s = _register("efficientnet_v2_s", _V2_S)
efficientnet_v2_m = _register("efficientnet_v2_m", _V2_M)
efficientnet_v2_l = _register("efficientnet_v2_l", _V2_L)
