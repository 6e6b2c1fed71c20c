"""TimeSformer with divided space-time attention (Bertasius, Wang and
Torresani, "Is Space-Time Attention All You Need for Video Understanding?",
ICML 2021, arXiv:2102.05095), at the widths of its high-resolution model
(``facebook/timesformer-hr-finetuned-k400``: 16 frames of 448², patch 16,
dim 768, 12 blocks of 12 heads of 64, MLP 3072, erf GELU, LayerNorm eps
1e-6, biased q, k, v).

The port has no JAX counterpart of this model: ``tests/
timesformer_reference.py`` writes the published forward in plain float32
PyTorch, and the tests hold this module to it.

- Embedding: each frame's patches by one product (as ``ViViT._patchify``),
  the spatial position table (785 rows: the CLS token's, then the
  patches') added to each frame, one CLS token a clip (the CLS token plus
  its position), the time table added to the patches of each frame.
- Each block, with x the patches and c the clip's CLS token:
  ``x_t = x + temporal_fc(Attn_t(LN_t(x)))``, attention over the frames at
  each patch position; then ``Attn_s(LN_1([c ; x_t]))`` within each frame
  over 785 tokens (the CLS copied into every frame); ``c' = c + mean over
  frames`` of the spatial CLS outputs, ``x' = x_t +`` the spatial patch
  outputs; then ``+ MLP(LN_2(·))`` on both, erf GELU.
- Output: the final LayerNorm on the CLS token, then the head, in float32.

dtypes follow the ViViT's rules (``models/vivit.py``): LayerNorm statistics
and affine in float32 with its result rounded to the compute dtype, the
products and the residual stream in the compute dtype, the frame mean of
the CLS outputs accumulated in float32 and rounded.

Both attentions are K4 (``FlashSelfAttention``, ``ops/flash_attention.py``):
the kernels on the card, their plain version on the CPU. The patches are
held frame-major, [B, T, N, D], which is the spatial attention's order; the
temporal attention reads the same tensor with the N patch positions folded
into the heads, q, k, v [B, T, N·H, hd], which K4 takes through their
strides, so that neither attention regroups the residual stream.
``remat`` recomputes each block in the backward (``torch.utils.checkpoint``).

Spans (``obs/profiling.annotate``): ``vcd.tsf.temporal`` (temporal
LayerNorm, projections, K4, out projection and ``temporal_fc``) and
``vcd.tsf.spatial`` (the CLS copies, LayerNorm, projections, K4, out
projection and the CLS mean), in every block.

Departures from the published model:

- q, k, v and the out projection are four linear layers (``FlashSelfAttention``'s
  parameters), where the published model has one fused ``qkv``;
- no stochastic depth and no dropout;
- a 3-class head in place of Kinetics-400's 400;
- seeded weights (``init_weights``) draw ``temporal_fc`` like any linear
  layer and the time table like the position tables, where the published
  initialisation zeroes both;
- the time table is sliced to the clip's T frames (at most its rows),
  where the published model interpolates it to another T.
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
from vision_collision_detection_tpu_torch.obs.profiling import annotate
from vision_collision_detection_tpu_torch.ops.flash_attention import (
    FlashSelfAttention,
    flash_mha,
)

LN_EPS = 1e-6  # the published layer_norm_eps


class DividedBlock(nn.Module):
    """One divided space-time block on (c [B, D], x [B, T, N, D])."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.temporal_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.temporal_attn = FlashSelfAttention(dim, num_heads, dtype)
        self.temporal_fc = nn.Linear(dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = FlashSelfAttention(dim, num_heads, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.mlp_fc2 = nn.Linear(dim * mlp_ratio, dim)

    def _temporal(self, x: torch.Tensor) -> torch.Tensor:
        """temporal_fc(Attn_t(LN_t(x))) over the frames at each position:
        the positions folded into the heads, [B, T, N·H, hd]."""
        B, T, N, D = x.shape
        attn = self.temporal_attn
        H, hd = attn.num_heads, attn.head_dim
        h = layer_norm(x, self.temporal_norm, self.dtype).view(B, T * N, D)
        q, k, v = (t.view(B, T, N * H, hd) for t in attn.heads(h))
        o = flash_mha(q, k, v, hd ** -0.5).view(B, T * N, H, hd)
        return linear(attn.project_out(o), self.temporal_fc,
                      self.dtype).view(B, T, N, D)

    def _mlp(self, t: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = F.gelu(linear(layer_norm(t, self.norm2, dt), self.mlp_fc1, dt))
        return t + linear(h, self.mlp_fc2, dt)

    def forward(self, c: torch.Tensor, x: torch.Tensor):
        B, T, N, D = x.shape
        with annotate("vcd.tsf.temporal"):
            x = x + self._temporal(x)
        with annotate("vcd.tsf.spatial"):
            xs = torch.cat([c[:, None, None].expand(B, T, 1, D), x], dim=2)
            h = layer_norm(xs, self.norm1, self.dtype).view(B * T, N + 1, D)
            r = self.attn(h).view(B, T, N + 1, D)
            c = c + r[:, :, 0].mean(dim=1)
            x = x + r[:, :, 1:]
        return self._mlp(c), self._mlp(x)


class TimeSformer(nn.Module):
    """Divided space-time attention over a clip: logits [B, classes]."""

    def __init__(self, num_patches: int, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, patch_size: int = 16,
                 num_frames: int = 16, num_classes: int = 3,
                 remat: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.dim = dim
        self.patch_size = patch_size
        self.remat = remat
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.empty(dim))
        self.pos_embed = nn.Parameter(torch.empty(num_patches + 1, dim))
        self.time_embed = nn.Parameter(torch.empty(num_frames, dim))
        self.blocks = nn.ModuleList(DividedBlock(dim, num_heads, dtype=dtype)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, num_classes)

    def _patchify(self, flat: torch.Tensor) -> torch.Tensor:
        """[N, H, W, C] → [N, (H/P)·(W/P), dim], as ``ViViT._patchify``."""
        N, H, W, C = flat.shape
        P, dt = self.patch_size, self.dtype
        patches = flat.to(dt).reshape(N, H // P, P, W // P, P, C).permute(
            0, 1, 3, 2, 4, 5).reshape(N, (H // P) * (W // P), P * P * C)
        w = self.patch_embed.weight.to(dt).permute(2, 3, 1, 0).reshape(
            P * P * C, self.dim)
        return torch.matmul(patches, w) + self.patch_embed.bias.to(dt)

    def forward(self, frames: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` is taken for the training step's call and not
        drawn from: the model has no dropout."""
        dt = self.dtype
        x = canonicalize_video_layout(frames).to(dt)
        B, T, H, W, C = x.shape
        P, D = self.patch_size, self.dim
        if H % P or W % P:
            raise ValueError(f"image size {(H, W)} not divisible by patch {P}")
        N = (H // P) * (W // P)
        if N + 1 != self.pos_embed.shape[0]:
            raise ValueError(
                f"frames of {(H, W)} give {N} patches, but the position "
                f"table was built for {self.pos_embed.shape[0] - 1}")
        if T > self.time_embed.shape[0]:
            raise ValueError(f"T={T} exceeds the time table's "
                             f"{self.time_embed.shape[0]} frames")
        pos = self.pos_embed.to(dt)
        x = (self._patchify(x.reshape(B * T, H, W, C)) + pos[1:]).view(
            B, T, N, D) + self.time_embed[:T].to(dt)[None, :, None]
        c = (self.cls_token.to(dt) + pos[0]).expand(B, D)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                c, x = checkpoint(block, c, x, use_reentrant=False)
            else:
                c, x = block(c, x)
        return linear(layer_norm(c, self.norm, dt), self.head, torch.float32)


_TIMESFORMER_SIZES = {
    # tiny: the preset for tests, through the same constructor
    "timesformer_tiny": dict(dim=64, depth=2, num_heads=4, num_frames=16),
    "timesformer_hr": dict(dim=768, depth=12, num_heads=12, num_frames=16),
}


def build_timesformer(cfg: ModelConfig,
                      frame_size: Optional[int] = None) -> TimeSformer:
    """The TimeSformer of ``cfg`` for square frames of side ``frame_size``
    (default ``cfg.image_size``), which fixes the position table. Both
    attentions are K4: ``cfg.attention_impl`` must be ``"flash"``."""
    if cfg.attention_impl != "flash":
        raise ValueError(f"{cfg.backbone} attends by K4 only: "
                         "attention_impl must be 'flash'")
    side = cfg.image_size if frame_size is None else frame_size
    if side % cfg.patch_size:
        raise ValueError(f"frame size {side} not divisible by patch "
                         f"{cfg.patch_size}")
    return TimeSformer(
        num_patches=(side // cfg.patch_size) ** 2,
        num_classes=cfg.num_classes,
        patch_size=cfg.patch_size,
        remat=cfg.remat,
        dtype=getattr(torch, cfg.dtype),
        **_TIMESFORMER_SIZES[cfg.backbone],
    )
