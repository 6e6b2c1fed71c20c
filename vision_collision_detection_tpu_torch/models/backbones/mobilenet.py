"""MobileNetV2 / MobileNetV3-Small frame backbones (NHWC).

Counterpart of ``vision_collision_detection_tpu/models/backbones/mobilenet.py``:
table-driven inverted-residual stacks with the JAX module tree
(``stem_conv``/``stem_bn``, ``block{i}`` with ``expand_conv``/``expand_bn``,
``dw_conv``/``dw_bn``, ``se`` (``fc1``, ``fc2``), ``project_conv``/
``project_bn``, ``head_conv``/``head_bn``). The activations are written as
the JAX file writes them (relu6, hardswish = x·relu6(x+3)/6, hardsigmoid =
relu6(x+3)/6). BatchNorm is flax's (``models/norm.py``) with eps 1e-3 and
momentum 0.9, but 0.99 for MobileNetV3-Small's stem and head, as the JAX
modules give them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vision_collision_detection_tpu_torch.models.backbones import (
    BACKBONE_REGISTRY,
)
from vision_collision_detection_tpu_torch.models.backbones.convnext import (
    conv_nhwc,
)
from vision_collision_detection_tpu_torch.models.backbones.resnet import (
    global_mean,
)
from vision_collision_detection_tpu_torch.models.norm import BatchNorm


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hardswish(x: torch.Tensor) -> torch.Tensor:
    return x * F.relu6(x + 3.0) / 6.0


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def _conv(cin, cout, k, stride=1, padding=0, groups=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     groups=groups, bias=False)


class SqueezeExcite(nn.Module):
    """Global mean → 1×1 conv → ReLU → 1×1 conv → ``gate`` → scale x (the
    convs with biases, as flax's default)."""

    def __init__(self, channels: int, squeeze: int,
                 gate: Callable = hardsigmoid, dtype=torch.bfloat16):
        super().__init__()
        self.gate = gate
        self.dtype = dtype
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        # jnp.mean of x in its dtype: a float32 sum rounded back
        s = x.to(torch.float32).mean(dim=(1, 2), keepdim=True).to(x.dtype)
        s = F.relu(conv_nhwc(s, self.fc1, dt))
        s = conv_nhwc(s, self.fc2, dt)
        return x * self.gate(s).to(x.dtype)


class InvertedResidual(nn.Module):
    """MBConv of MobileNetV2/V3: [1×1 expand] → depthwise k×k → [SE] → 1×1
    project, with the residual where stride is 1 and the widths agree."""

    def __init__(self, cin: int, out_ch: int, exp_ch: int, kernel: int = 3,
                 strides: int = 1, use_se: bool = False, se_squeeze: int = 0,
                 act: Callable = F.relu6, dtype=torch.bfloat16):
        super().__init__()
        self.act = act
        self.dtype = dtype
        self.residual = strides == 1 and cin == out_ch
        if exp_ch != cin:
            self.expand_conv = _conv(cin, exp_ch, 1)
            self.expand_bn = self._bn(exp_ch)
        self.dw_conv = _conv(exp_ch, exp_ch, kernel, strides, kernel // 2,
                             groups=exp_ch)
        self.dw_bn = self._bn(exp_ch)
        if use_se:
            self.se = SqueezeExcite(exp_ch, se_squeeze, dtype=dtype)
        self.project_conv = _conv(exp_ch, out_ch, 1)
        self.project_bn = self._bn(out_ch)

    def _bn(self, c):
        return BatchNorm(c, momentum=0.9, eps=1e-3, dtype=self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = x
        if hasattr(self, "expand_conv"):
            y = self.act(self.expand_bn(conv_nhwc(y, self.expand_conv, dt)))
        y = self.act(self.dw_bn(conv_nhwc(y, self.dw_conv, dt)))
        if hasattr(self, "se"):
            y = self.se(y)
        y = self.project_bn(conv_nhwc(y, self.project_conv, dt))
        return y + x if self.residual else y


# (expand_ratio, out_ch, repeats, stride): the standard MobileNetV2 table
_V2_TABLE = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class MobileNetV2(nn.Module):
    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem_conv = _conv(3, 32, 3, 2, 1)
        self.stem_bn = BatchNorm(32, momentum=0.9, eps=1e-3, dtype=dtype)
        cin, idx = 32, 0
        for t, c, n, s in _V2_TABLE:
            for i in range(n):
                self.add_module(f"block{idx}", InvertedResidual(
                    cin, c, cin * t, kernel=3, strides=s if i == 0 else 1,
                    act=F.relu6, dtype=dtype))
                cin, idx = c, idx + 1
        self.num_blocks = idx
        self.head_conv = _conv(cin, 1280, 1)
        self.head_bn = BatchNorm(1280, momentum=0.9, eps=1e-3, dtype=dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        x = F.relu6(self.stem_bn(conv_nhwc(x, self.stem_conv, dt)))
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        x = F.relu6(self.head_bn(conv_nhwc(x, self.head_conv, dt)))
        return global_mean(x, dt)


# (kernel, exp_ch, out_ch, use_se, use_hs, stride): MobileNetV3-Small
_V3_SMALL_TABLE = (
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
)


class MobileNetV3Small(nn.Module):
    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem_conv = _conv(3, 16, 3, 2, 1)
        self.stem_bn = BatchNorm(16, momentum=0.99, eps=1e-3, dtype=dtype)
        cin = 16
        for idx, (k, exp, out, se, hs, s) in enumerate(_V3_SMALL_TABLE):
            self.add_module(f"block{idx}", InvertedResidual(
                cin, out, exp, kernel=k, strides=s, use_se=se,
                se_squeeze=_make_divisible(exp // 4),
                act=hardswish if hs else F.relu, dtype=dtype))
            cin = out
        self.head_conv = _conv(cin, 576, 1)
        self.head_bn = BatchNorm(576, momentum=0.99, eps=1e-3, dtype=dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        x = hardswish(self.stem_bn(conv_nhwc(x, self.stem_conv, dt)))
        for i in range(len(_V3_SMALL_TABLE)):
            x = getattr(self, f"block{i}")(x)
        x = hardswish(self.head_bn(conv_nhwc(x, self.head_conv, dt)))
        return global_mean(x, dt)


@BACKBONE_REGISTRY.register("mobilenet_v2")
def mobilenet_v2(dtype=None, **kwargs):
    return MobileNetV2(dtype=dtype or torch.bfloat16, **kwargs)


@BACKBONE_REGISTRY.register("mobilenet_v3_small")
def mobilenet_v3_small(dtype=None, **kwargs):
    return MobileNetV3Small(dtype=dtype or torch.bfloat16, **kwargs)
