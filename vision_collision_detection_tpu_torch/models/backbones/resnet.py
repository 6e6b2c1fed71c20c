"""ResNet-18 / ResNet-50 frame backbones (NHWC).

Counterpart of ``vision_collision_detection_tpu/models/backbones/resnet.py``:
the ResNet v1 recipe with the JAX module tree (``stem_conv``, ``stem_bn``,
``layer{stage}_{block}`` with ``conv1``/``bn1``... and
``downsample_conv``/``downsample_bn``), so the flax bridge maps name to
name. Explicit paddings as the JAX file writes them (3 for the stem, 1 for
the 3×3s, a max pool padded by 1), never flax's ``SAME``. Convolutions have
no bias; every BatchNorm is flax's (``models/norm.py``) with momentum 0.9
and eps 1e-5. Activations and convolutions in the compute dtype; features
leave as float32 after the global mean.
"""

from __future__ import annotations

from typing import Optional, Sequence, Type

import torch
import torch.nn as nn
import torch.nn.functional as F

from vision_collision_detection_tpu_torch.models.backbones import (
    BACKBONE_REGISTRY,
)
from vision_collision_detection_tpu_torch.models.backbones.convnext import (
    conv_nhwc,
)
from vision_collision_detection_tpu_torch.models.norm import BatchNorm


def global_mean(x: torch.Tensor, dtype) -> torch.Tensor:
    """``jnp.mean(x, axis=(1, 2))`` of an NHWC map in ``dtype`` (a float32
    sum, rounded to ``dtype``), returned as float32 features [N, C]."""
    return x.to(torch.float32).mean(dim=(1, 2)).to(dtype).to(torch.float32)


def _conv(cin, cout, k, stride=1, padding=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


def _bn(c, dtype):
    return BatchNorm(c, momentum=0.9, eps=1e-5, dtype=dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, strides: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(cin, features, 3, strides, 1)
        self.bn1 = _bn(features, dtype)
        self.conv2 = _conv(features, features, 3, 1, 1)
        self.bn2 = _bn(features, dtype)
        if strides != 1 or cin != features:
            self.downsample_conv = _conv(cin, features, 1, strides)
            self.downsample_bn = _bn(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.relu(self.bn1(conv_nhwc(x, self.conv1, dt)))
        y = self.bn2(conv_nhwc(y, self.conv2, dt))
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(
                conv_nhwc(x, self.downsample_conv, dt))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (strided) → 1×1 to 4 × ``features``."""

    expansion = 4

    def __init__(self, cin: int, features: int, strides: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        out = 4 * features
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = _bn(features, dtype)
        self.conv2 = _conv(features, features, 3, strides, 1)
        self.bn2 = _bn(features, dtype)
        self.conv3 = _conv(features, out, 1)
        self.bn3 = _bn(out, dtype)
        if strides != 1 or cin != out:
            self.downsample_conv = _conv(cin, out, 1, strides)
            self.downsample_bn = _bn(out, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.relu(self.bn1(conv_nhwc(x, self.conv1, dt)))
        y = F.relu(self.bn2(conv_nhwc(y, self.conv2, dt)))
        y = self.bn3(conv_nhwc(y, self.conv3, dt))
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(
                conv_nhwc(x, self.downsample_conv, dt))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """NHWC frames [N, H, W, 3] → pooled float32 features [N, D]."""

    def __init__(self, stage_sizes: Sequence[int],
                 block: Type[nn.Module], dtype=torch.bfloat16):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        self.stem_conv = _conv(3, 64, 7, 2, 3)
        self.stem_bn = _bn(64, dtype)
        cin = 64
        for stage, n in enumerate(self.stage_sizes):
            for blk in range(n):
                strides = 2 if stage > 0 and blk == 0 else 1
                features = 64 * 2 ** stage
                self.add_module(f"layer{stage + 1}_{blk}",
                                block(cin, features, strides, dtype))
                cin = features * block.expansion

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        x = F.relu(self.stem_bn(conv_nhwc(x, self.stem_conv, dt)))
        # max pool 3×3 / 2 padded by 1 with -inf, as flax's max_pool
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for stage, n in enumerate(self.stage_sizes):
            for blk in range(n):
                x = getattr(self, f"layer{stage + 1}_{blk}")(x)
        return global_mean(x, dt)


@BACKBONE_REGISTRY.register("resnet18")
def resnet18(dtype=None, **kwargs):
    return ResNet((2, 2, 2, 2), BasicBlock, dtype=dtype or torch.bfloat16,
                  **kwargs)


@BACKBONE_REGISTRY.register("resnet50")
def resnet50(dtype=None, **kwargs):
    return ResNet((3, 4, 6, 3), Bottleneck, dtype=dtype or torch.bfloat16,
                  **kwargs)
