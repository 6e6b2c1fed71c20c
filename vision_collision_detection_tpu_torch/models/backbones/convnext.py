"""ConvNeXt tiny/base/large frame backbones (NHWC).

Counterpart of ``vision_collision_detection_tpu/models/backbones/convnext.py``.
Activations stay NHWC contiguous; the convolutions see them as channels_last
NCHW views through ``permute``, which copies nothing.

dtype semantics follow flax's ``dtype=`` layers: each layer casts its input
and its float32 parameters to the compute dtype, written out as explicit
casts (not ``torch.autocast``, which keeps LayerNorm in float32 and rounds
elsewhere). LayerNorm statistics are float32; features leave the backbone
as float32 after the global mean.

Each block keeps the JAX switches: ``dwconv_kernel`` (JAX
``dwconv_pallas``) runs the depthwise 7×7 through K2 (``ops/dwconv.py``),
``fused_mlp`` runs LN→MLP→scale→residual through K3
(``ops/convnext_mlp.py``). ``None`` means the module default: K2 at every
stage and dtype (``DWCONV_KERNEL_DEFAULT``; its float32 route sums in
float32), K3 only on bf16 activations (``fused_mlp_default``). With a
switch ``False`` the block runs stock PyTorch layers, the counterpart of
the flax path; ``fused_mlp=True`` sends float32 activations to K3 too, as
the JAX package's ``fused_mlp=True`` does.

The stem and downsample convolutions pad as ``padding`` says: flax's
``"SAME"`` (the default, the JAX package's), or ``"VALID"``: no padding,
the remainder of an odd side dropped, as torchvision's ``Conv2d(k, s,
padding=0)`` does (the reference's checkpoints, ``models/reference_model``;
the JAX package pads those ``SAME`` too, which departs from torchvision
where a stage's side is odd, e.g. the last downsample at 112²).

Stochastic depth follows the flax block: ``drop_path_rate`` per block on
the linear schedule over the blocks, active only in training
(``self.training``, flax's ``train``), where the block takes the unfused
path and drops whole samples of its residual branch with a mask drawn from
the ``generator`` the caller passes in.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vision_collision_detection_tpu_torch.models.backbones import (
    BACKBONE_REGISTRY,
)
from vision_collision_detection_tpu_torch.ops.convnext_mlp import convnext_mlp
from vision_collision_detection_tpu_torch.ops.dwconv import dwconv7x7
from vision_collision_detection_tpu_torch.utils.precision import cudnn_float32

LN_EPS = 1e-6
DWCONV_KERNEL_DEFAULT = True
# K3 by default, on bf16 activations only (``fused_mlp_default``).
FUSED_MLP_DEFAULT = True
PADDINGS = ("SAME", "VALID")


def fused_mlp_default(dtype) -> bool:
    """Whether a block of compute dtype ``dtype`` takes K3 when its
    ``fused_mlp`` is None: ``FUSED_MLP_DEFAULT`` on bf16, never on float32.
    K3 rounds t, h_pre and h to bf16 (its rule), where flax's bf16 chain
    rounds them and its float32 chain does not; so a float32 block runs the
    stock chain, what the JAX package computes by default (its
    ``FUSED_MLP_DEFAULT`` is False)."""
    return FUSED_MLP_DEFAULT and dtype == torch.bfloat16


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype)``: float32 statistics and affine,
    result cast to ``dtype``."""
    return F.layer_norm(x.to(torch.float32), norm.normalized_shape,
                        norm.weight, norm.bias, norm.eps).to(dtype)


def same_pads(size: int, k: int, s: int):
    """flax's ``SAME`` padding of one spatial axis for a ``k``-wide window
    at stride ``s``: ⌈size/s⌉ outputs, the total pad split with the smaller
    half first."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype,
              same: bool = False) -> torch.Tensor:
    """flax ``nn.Conv(dtype=dtype)`` on NHWC ``x``. ``same``: pad with zeros
    in ``dtype`` as flax's default ``SAME`` does (the stem and downsample
    convolutions, whose ``conv.padding`` is 0); otherwise ``conv.padding``
    (the stock depthwise conv's explicit 3, the BatchNorm backbones'
    explicit pads, the stem's and downsamples' 0 under ``"VALID"``). A
    float32 convolution runs without TF32
    (``utils/precision.py``), as flax's does."""
    x = x.to(dtype)
    if same:
        top, bottom = same_pads(x.shape[1], conv.kernel_size[0],
                                conv.stride[0])
        left, right = same_pads(x.shape[2], conv.kernel_size[1],
                                conv.stride[1])
        if top or bottom or left or right:
            x = F.pad(x, (0, 0, left, right, top, bottom))
    bias = None if conv.bias is None else conv.bias.to(dtype)
    args = (x.permute(0, 3, 1, 2), conv.weight.to(dtype), bias, conv.stride,
            conv.padding, 1, conv.groups)
    y = (cudnn_float32(F.conv2d, *args) if dtype == torch.float32
         else F.conv2d(*args))
    return y.permute(0, 2, 3, 1).contiguous()


def linear(x: torch.Tensor, fc: nn.Linear, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``."""
    return F.linear(x.to(dtype), fc.weight.to(dtype), fc.bias.to(dtype))


class DwConv7x7(nn.Module):
    """Parameters of the K2 path: ``weight`` [49, C] (tap ``dy*7 + dx``
    major, the kernel's layout) and ``bias`` [C]."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(49, dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6,
                 drop_path_rate: float = 0.0,
                 gelu_approximate: bool = False,
                 dwconv_kernel: Optional[bool] = None,
                 fused_mlp: Optional[bool] = None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dim = dim
        self.drop_path_rate = float(drop_path_rate)
        self.gelu_approximate = gelu_approximate
        self.use_dwconv_kernel = (DWCONV_KERNEL_DEFAULT if dwconv_kernel is None
                                  else bool(dwconv_kernel))
        self.use_fused_mlp = (fused_mlp_default(dtype) if fused_mlp is None
                              else bool(fused_mlp))
        self.dtype = dtype
        if self.use_dwconv_kernel:
            self.dwconv = DwConv7x7(dim)
        else:
            self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale_init)))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        shortcut = x
        if self.use_dwconv_kernel:
            y = dwconv7x7(x.to(dt).contiguous(), self.dwconv.weight.to(dt),
                          self.dwconv.bias.to(dt))
        else:
            y = conv_nhwc(x, self.dwconv, dt)
        drop_path_active = self.training and self.drop_path_rate > 0.0
        if self.use_fused_mlp and not drop_path_active:
            # The kernel writes its output in the shortcut's dtype, as the
            # unfused residual add promotes to it.
            return convnext_mlp(
                shortcut.contiguous(), y.to(dt).contiguous(),
                self.norm.weight, self.norm.bias,
                self.pwconv1.weight.t(), self.pwconv1.bias,
                self.pwconv2.weight.t(), self.pwconv2.bias, self.gamma,
                self.gelu_approximate)
        y = layer_norm(y, self.norm, dt)
        y = linear(y, self.pwconv1, dt)
        y = F.gelu(y, approximate="tanh" if self.gelu_approximate else "none")
        y = linear(y, self.pwconv2, dt)
        y = y * self.gamma.to(dt)
        if drop_path_active:
            if generator is None:
                raise ValueError("drop-path in training draws its mask from "
                                 "a generator; pass generator=")
            keep = 1.0 - self.drop_path_rate
            mask = torch.bernoulli(
                torch.full((y.shape[0], 1, 1, 1), keep, device=y.device),
                generator=generator)
            y = torch.where(mask.bool(), y / keep, torch.zeros_like(y)).to(dt)
        return shortcut + y


class ConvNeXt(nn.Module):
    """NHWC frames [N, H, W, 3] → pooled (and head-normed) features [N, D]
    in float32. Any H and W: the stem and downsample convolutions pad as
    ``padding`` says, flax's ``"SAME"`` or torchvision's ``"VALID"``."""

    def __init__(self, depths: Sequence[int], dims: Sequence[int],
                 drop_path_rate: float = 0.0,
                 apply_head_norm: bool = True, gelu_approximate: bool = False,
                 dwconv_kernel: Optional[bool] = None,
                 fused_mlp: Optional[bool] = None, dtype=torch.bfloat16,
                 padding: str = "SAME"):
        super().__init__()
        if padding not in PADDINGS:
            raise ValueError(f"padding must be one of {PADDINGS}, got "
                             f"{padding!r}")
        self.depths = tuple(depths)
        self.dims = tuple(dims)
        self.apply_head_norm = apply_head_norm
        self.dtype = dtype
        self.padding = padding
        self.stem_conv = nn.Conv2d(3, dims[0], 4, stride=4)
        self.stem_norm = nn.LayerNorm(dims[0], eps=LN_EPS)
        total_blocks = sum(self.depths)
        block_idx = 0
        for stage, depth in enumerate(self.depths):
            if stage > 0:
                self.add_module(f"downsample{stage}_norm",
                                nn.LayerNorm(dims[stage - 1], eps=LN_EPS))
                self.add_module(f"downsample{stage}_conv",
                                nn.Conv2d(dims[stage - 1], dims[stage], 2,
                                          stride=2))
            for blk in range(depth):
                dp = drop_path_rate * block_idx / max(total_blocks - 1, 1)
                self.add_module(f"stage{stage}_block{blk}", ConvNeXtBlock(
                    dims[stage], drop_path_rate=dp,
                    gelu_approximate=gelu_approximate,
                    dwconv_kernel=dwconv_kernel, fused_mlp=fused_mlp,
                    dtype=dtype))
                block_idx += 1
        if apply_head_norm:
            self.head_norm = nn.LayerNorm(dims[-1], eps=LN_EPS)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: the drop-path masks' source in training."""
        dt, same = self.dtype, self.padding == "SAME"
        x = conv_nhwc(x, self.stem_conv, dt, same=same)
        x = layer_norm(x, self.stem_norm, dt)
        for stage, depth in enumerate(self.depths):
            if stage > 0:
                x = layer_norm(x, getattr(self, f"downsample{stage}_norm"), dt)
                x = conv_nhwc(x, getattr(self, f"downsample{stage}_conv"), dt,
                              same=same)
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x, generator)
        # global mean pool: float32 sum, result in the compute dtype
        x = x.to(torch.float32).mean(dim=(1, 2)).to(dt)
        if self.apply_head_norm:
            x = layer_norm(x, self.head_norm, torch.float32)
        return x.to(torch.float32)


@BACKBONE_REGISTRY.register("convnext_tiny")
def convnext_tiny(dtype=None, **kwargs):
    return ConvNeXt(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                    dtype=dtype or torch.bfloat16, **kwargs)


@BACKBONE_REGISTRY.register("convnext_base")
def convnext_base(dtype=None, **kwargs):
    return ConvNeXt(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024),
                    dtype=dtype or torch.bfloat16, **kwargs)


@BACKBONE_REGISTRY.register("convnext_large")
def convnext_large(dtype=None, **kwargs):
    return ConvNeXt(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536),
                    dtype=dtype or torch.bfloat16, **kwargs)
