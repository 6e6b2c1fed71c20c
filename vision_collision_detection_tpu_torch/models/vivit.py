"""Factorized space-time video transformer (ViViT-style), the scaled variant.

Counterpart of ``vision_collision_detection_tpu/models/vivit.py``: per-frame
patch embedding, spatial transformer blocks over each frame's patches, the
mean over patches as the frame's summary, temporal blocks over the frames,
the mean over frames, and a float32 head.

dtype semantics follow flax's ``dtype=`` layers, written out as explicit
casts as in ``backbones/convnext.py``: LayerNorm (eps 1e-6, flax's default)
takes float32 statistics and rounds its output, the projections and the MLP
run in the compute dtype, GELU is the tanh form, the two means accumulate in
float32 and round to the compute dtype.

``attention_impl`` picks the spatial blocks' attention, on one parameter
tree (query, key, value, out projections):

- ``"flash"``: K4 (``ops/flash_attention.py``): float32 logits scaled by
  1/√d, float32 softmax. A CUDA tensor launches the kernels or raises.
- ``"xla"`` (the name is the JSON config's): stock attention written out as
  flax's ``MultiHeadDotProductAttention`` computes it: q scaled by 1/√d in
  the compute dtype, logits and softmax in the compute dtype.

The temporal blocks always take the stock attention, as in the JAX model.
The two impls agree to the compute dtype's resolution, not bit for bit.

The spatial position table's length is fixed at construction
(``num_patches``): flax sizes it from the input it is initialised on, an
``nn.Module`` needs it up front. ``remat`` wraps each spatial block in
``torch.utils.checkpoint`` where a gradient is taken, so its activations
are recomputed in the backward (and K4's forward kernel runs twice).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vision_collision_detection_tpu_torch.config import ModelConfig
from vision_collision_detection_tpu_torch.models.backbones.convnext import (
    layer_norm,
    linear,
)
from vision_collision_detection_tpu_torch.models.video_classifier import (
    canonicalize_video_layout,
)
from vision_collision_detection_tpu_torch.ops.flash_attention import (
    FlashSelfAttention,
)

LN_EPS = 1e-6


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 dropout: float = 0.0, dtype=torch.bfloat16,
                 attention_impl: str = "xla"):
        super().__init__()
        if attention_impl not in ("xla", "flash"):
            raise ValueError(f"attention_impl {attention_impl!r} not in "
                             "('xla', 'flash')")
        self.dropout = float(dropout)
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = FlashSelfAttention(dim, num_heads, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.mlp_fc2 = nn.Linear(dim * mlp_ratio, dim)

    def _stock_attention(self, x: torch.Tensor,
                         generator: Optional[torch.Generator]) -> torch.Tensor:
        """flax ``MultiHeadDotProductAttention(dtype=dtype)`` on (x, x):
        q/√d, logits and softmax in the compute dtype; in training the
        attention dropout is one mask broadcast over batch and heads."""
        q, k, v = self.attn.heads(x)
        q = q / torch.tensor(q.shape[-1] ** 0.5).to(self.dtype)
        w = torch.matmul(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))
        w = torch.softmax(w, dim=-1)
        if self.training and self.dropout > 0.0:
            if generator is None:
                raise ValueError("attention dropout in training draws its "
                                 "mask from a generator; pass generator=")
            keep = 1.0 - self.dropout
            mask = torch.bernoulli(
                torch.full((1, 1) + tuple(w.shape[-2:]), keep,
                           device=w.device), generator=generator)
            w = w * (mask.to(w.dtype) / torch.tensor(keep, dtype=w.dtype))
        o = torch.matmul(w, v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
        return self.attn.project_out(o)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        h = layer_norm(x, self.norm1, dt)
        if self.attention_impl == "flash":
            if self.dropout:
                raise ValueError("flash attention has no attention-dropout; "
                                 "use attention_impl='xla' or dropout=0")
            h = self.attn(h)
        else:
            h = self._stock_attention(h, generator)
        x = x + h
        h = layer_norm(x, self.norm2, dt)
        h = F.gelu(linear(h, self.mlp_fc1, dt), approximate="tanh")
        return x + linear(h, self.mlp_fc2, dt)


class ViViT(nn.Module):
    """Factorized encoder: spatial blocks per frame → temporal blocks."""

    def __init__(self, num_patches: int, dim: int = 384,
                 spatial_layers: int = 8, temporal_layers: int = 4,
                 num_heads: int = 6, patch_size: int = 14,
                 num_classes: int = 3, max_frames: int = 64,
                 dropout: float = 0.0, remat: bool = False,
                 dtype=torch.bfloat16, attention_impl: str = "xla"):
        super().__init__()
        self.dim = dim
        self.spatial_layers = spatial_layers
        self.temporal_layers = temporal_layers
        self.patch_size = patch_size
        self.max_frames = max_frames
        self.dropout = float(dropout)
        self.remat = remat
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.spatial_pos = nn.Parameter(torch.empty(num_patches, dim))
        for i in range(spatial_layers):
            setattr(self, f"spatial_{i}", TransformerBlock(
                dim, num_heads, dropout=dropout, dtype=dtype,
                attention_impl=attention_impl))
        self.spatial_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.temporal_pos = nn.Parameter(torch.empty(max_frames, dim))
        for i in range(temporal_layers):
            setattr(self, f"temporal_{i}", TransformerBlock(
                dim, num_heads, dropout=dropout, dtype=dtype))
        self.temporal_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, num_classes)

    def _patchify(self, flat: torch.Tensor) -> torch.Tensor:
        """flax ``nn.Conv(dim, (P, P), strides=(P, P), dtype=dtype)`` on
        NHWC frames, as one product over the flattened patches:
        [N, H, W, C] → [N, (H/P)·(W/P), dim]."""
        N, H, W, C = flat.shape
        P, dt = self.patch_size, self.dtype
        patches = flat.to(dt).reshape(N, H // P, P, W // P, P, C).permute(
            0, 1, 3, 2, 4, 5).reshape(N, (H // P) * (W // P), P * P * C)
        w = self.patch_embed.weight.to(dt).permute(2, 3, 1, 0).reshape(
            P * P * C, self.dim)
        return torch.matmul(patches, w) + self.patch_embed.bias.to(dt)

    def forward(self, frames: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: the attention dropout masks' source in training
        (only drawn where ``dropout`` > 0)."""
        dt = self.dtype
        x = canonicalize_video_layout(frames).to(dt)
        B, T, H, W, C = x.shape
        P = self.patch_size
        if H % P or W % P:
            raise ValueError(f"image size {(H, W)} not divisible by patch {P}")
        n_patches = (H // P) * (W // P)
        if n_patches != self.spatial_pos.shape[0]:
            raise ValueError(
                f"frames of {(H, W)} give {n_patches} patches, but the "
                f"spatial position table was built for "
                f"{self.spatial_pos.shape[0]}")
        if T > self.max_frames:
            raise ValueError(f"T={T} exceeds max_frames={self.max_frames}")

        tokens = self._patchify(x.reshape(B * T, H, W, C))
        tokens = tokens + self.spatial_pos.to(dt)
        remat = self.remat and torch.is_grad_enabled()
        if remat and self.training and self.dropout > 0.0:
            raise ValueError("remat with attention dropout would draw other "
                             "masks in the recomputed forward; use dropout=0")
        for i in range(self.spatial_layers):
            block = getattr(self, f"spatial_{i}")
            if remat:
                tokens = checkpoint(block, tokens, generator,
                                    use_reentrant=False)
            else:
                tokens = block(tokens, generator)
        tokens = layer_norm(tokens, self.spatial_norm, dt)

        # per-frame summary → temporal sequence [B, T, dim]
        frame_repr = tokens.mean(dim=1).reshape(B, T, self.dim)
        frame_repr = frame_repr + self.temporal_pos[:T].to(dt)
        for i in range(self.temporal_layers):
            frame_repr = getattr(self, f"temporal_{i}")(frame_repr, generator)
        frame_repr = layer_norm(frame_repr, self.temporal_norm, dt)
        pooled = frame_repr.mean(dim=1)
        return linear(pooled, self.head, torch.float32)


_VIVIT_SIZES = {
    # tiny: the preset for tests and dry runs, through the same constructor
    "vivit_tiny": dict(dim=64, spatial_layers=2, temporal_layers=1, num_heads=4),
    "vivit_small": dict(dim=384, spatial_layers=8, temporal_layers=4, num_heads=6),
    "vivit_base": dict(dim=768, spatial_layers=12, temporal_layers=4, num_heads=12),
}


def build_vivit(cfg: ModelConfig, frame_size: Optional[int] = None) -> ViViT:
    """The ViViT of ``cfg`` for square frames of side ``frame_size``
    (default ``cfg.image_size``), which fixes the spatial position table."""
    side = cfg.image_size if frame_size is None else frame_size
    if side % cfg.patch_size:
        raise ValueError(f"frame size {side} not divisible by patch "
                         f"{cfg.patch_size}")
    return ViViT(
        num_patches=(side // cfg.patch_size) ** 2,
        num_classes=cfg.num_classes,
        patch_size=cfg.patch_size,
        dropout=0.0,
        remat=cfg.remat,
        dtype=getattr(torch, cfg.dtype),
        attention_impl=cfg.attention_impl,
        **_VIVIT_SIZES[cfg.backbone],
    )
