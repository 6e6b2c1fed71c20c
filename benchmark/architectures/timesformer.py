"""TimeSformer with divided space-time attention (Bertasius, Wang and
Torresani, arXiv:2102.05095), at the widths of
``facebook/timesformer-hr-finetuned-k400``: the configuration of
``configs/timesformer_hr.json``.

- The reference forward (``logits``): each frame's patches embedded by one
  product, the spatial position table (the CLS token's row, then the
  patches') and the time table; then each block: attention over the
  frames at each patch position, its out projection and ``temporal_fc``
  added to the patches; attention within each frame over its patches and
  a copy of the clip's CLS token, the frames' CLS outputs averaged into the
  CLS token, the patch outputs added to the patches; an erf-GELU MLP on
  both. Pre-norm LayerNorms; the final one on the CLS token, then the head
  in float32. No dropout or stochastic depth. The attention is computed in
  chunks of sequences and each block is recomputed in the backward
  (``ckpt``), so that a float32 step at B=8 fits the card.
- The parameters: the port's names (q, k, v and out projections apart,
  where the published model fuses q, k, v); the CLS token and both tables
  N(0, 0.02²); ``temporal_fc`` drawn as any linear layer (the published
  initialisation zeroes it); no part is frozen.
- The launches of K4 (both attentions of every block) in one forward or
  training step at batch B, and the clip's FLOPs.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.architectures.vivit import attention
from benchmark.counts import Launch, k4_di, k4_dkv, k4_dq, k4_fwd
from benchmark.reference.models import layer_norm, linear
from benchmark.reference.products import FLOAT32, Products
from benchmark.reference.weights import Spec, linear_spec, norm_spec

# float32 logits held at once by the chunked attention
CHUNK_ELEMENTS = 2 ** 28


# ---- parameters ---------------------------------------------------------------------

def _attention_spec(spec: Spec, name: str, dim: int):
    for p in ("query", "key", "value", "out"):
        linear_spec(spec, f"{name}.{p}", dim, dim)


def param_spec(c: dict) -> Spec:
    dim, P = c["dim"], c["patch_size"]
    spec: Spec = [
        ("patch_embed.weight", (dim, 3, P, P), ("normal", (3 * P * P) ** -0.5)),
        ("patch_embed.bias", (dim,), ("normal", 0.1)),
        ("cls_token", (dim,), ("normal", 0.02)),
        ("pos_embed", (tokens(c) + 1, dim), ("normal", 0.02)),
        ("time_embed", (c["num_frames"], dim), ("normal", 0.02)),
    ]
    for i in range(c["layers"]):
        name = f"blocks.{i}"
        norm_spec(spec, f"{name}.temporal_norm", dim)
        _attention_spec(spec, f"{name}.temporal_attn", dim)
        linear_spec(spec, f"{name}.temporal_fc", dim, dim)
        norm_spec(spec, f"{name}.norm1", dim)
        _attention_spec(spec, f"{name}.attn", dim)
        norm_spec(spec, f"{name}.norm2", dim)
        linear_spec(spec, f"{name}.mlp_fc1", dim, c["mlp_dim"])
        linear_spec(spec, f"{name}.mlp_fc2", c["mlp_dim"], dim)
    norm_spec(spec, "norm", dim)
    linear_spec(spec, "head", dim, c["num_classes"], c["logit_scale"])
    return spec


def frozen_mask(name: str, c: dict):
    return None


# ---- the reference forward ------------------------------------------------------------

def _attend(prec, x, P, name, heads):
    """Self-attention of x [N, S, D] with its projections: [N, S, D]."""
    N, S, D = x.shape
    q, k, v = (linear(prec, x, P, f"{name}.{p}").view(
        N, S, heads, D // heads).transpose(1, 2)
        for p in ("query", "key", "value"))
    chunk = max(1, CHUNK_ELEMENTS // (heads * S * S))
    o = attention(prec, q, k, v, chunk).transpose(1, 2).reshape(N, S, D)
    return linear(prec, o, P, name + ".out")


def divided_block(P, name, heads, prec):
    def mlp(t):
        h = F.gelu(linear(prec, layer_norm(t, P, name + ".norm2"), P,
                          name + ".mlp_fc1"))
        return prec.act(t + linear(prec, h, P, name + ".mlp_fc2"))

    def block(c, x):
        """c [B, D] the clip's CLS token, x [B, T, N, D] the patches."""
        B, T, N, D = x.shape
        # over the frames at each patch position
        h = layer_norm(x, P, name + ".temporal_norm").transpose(1, 2).reshape(
            B * N, T, D)
        r = _attend(prec, h, P, name + ".temporal_attn", heads)
        r = r.view(B, N, T, D).transpose(1, 2)
        x = prec.act(x + linear(prec, r, P, name + ".temporal_fc"))
        # within each frame, over the CLS token's copy and the patches
        xs = torch.cat([c[:, None, None].expand(B, T, 1, D), x], dim=2)
        r = _attend(prec, layer_norm(xs, P, name + ".norm1").view(
            B * T, N + 1, D), P, name + ".attn", heads).view(B, T, N + 1, D)
        c = prec.act(c + r[:, :, 0].mean(dim=1))
        x = prec.act(x + r[:, :, 1:])
        return mlp(c), mlp(x)
    return block


def logits(P, frames, c, prec: Products = FLOAT32, training: bool = False,
           generator=None, ckpt: bool = False):
    """Model-ready float32 frames [B, T, S, S, 3] → logits [B, classes]."""
    B, T, H, W, C = frames.shape
    p, D = c["patch_size"], c["dim"]
    N = (H // p) * (W // p)
    patches = frames.reshape(B * T, H // p, p, W // p, p, C).permute(
        0, 1, 3, 2, 4, 5).reshape(B * T, N, p * p * C)
    w = P["patch_embed.weight"].permute(2, 3, 1, 0).reshape(p * p * C, D)
    x = prec.act(prec.matmul(patches, w) + P["patch_embed.bias"])
    x = prec.act(x + P["pos_embed"][1:]).view(B, T, N, D)
    x = prec.act(x + P["time_embed"][:T, None])
    cls = prec.act(P["cls_token"] + P["pos_embed"][0]).expand(B, D)
    for i in range(c["layers"]):
        block = divided_block(P, f"blocks.{i}", c["heads"], prec)
        if ckpt and torch.is_grad_enabled():
            cls, x = checkpoint(block, cls, x, use_reentrant=False)
        else:
            cls, x = block(cls, x)
    return FLOAT32.linear(layer_norm(cls, P, "norm"), P["head.weight"],
                          P["head.bias"])


# ---- launches and FLOPs -------------------------------------------------------------------

def tokens(c: dict) -> int:
    """Patches a frame."""
    return (c["frame_size"] // c["patch_size"]) ** 2


def k4_launches(c: dict, B: int, train: bool) -> Dict[str, List[Launch]]:
    """K4's launches by kernel (``fwd``; in training also ``di``, ``dkv``,
    ``dq``), one of each at each shape a block: the temporal attention
    over B·N sequences of the T frames, the spatial over B·T sequences of
    the N + 1 tokens."""
    T, N, Hh = c["frames"], tokens(c), c["heads"]
    D, L = c["dim"] // Hh, c["layers"]
    shapes = ((B * N, T, Hh, D), (B * T, N + 1, Hh, D))
    out = {"fwd": [k4_fwd(*s, train) for s in shapes] * L}
    if train:
        for kind, fn in (("di", k4_di), ("dkv", k4_dkv), ("dq", k4_dq)):
            out[kind] = [fn(*s) for s in shapes] * L
    return out


def clip_flops(c: dict, train: bool) -> tuple:
    """(FLOPs of one clip's forward, FLOPs of its patch embedding)."""
    T, N, d, mlp = c["frames"], tokens(c), c["dim"], c["mlp_dim"]
    p = c["patch_size"]
    embed = 2.0 * T * N * 3 * p * p * d
    temporal = 2.0 * T * N * 5 * d * d + 4.0 * T * T * d * N
    spatial = 2.0 * T * (N + 1) * 4 * d * d + 4.0 * (N + 1) ** 2 * d * T
    mlp_f = 2.0 * (T * N + 1) * 2 * d * mlp
    f = embed + c["layers"] * (temporal + spatial + mlp_f)
    return f + 2.0 * d * c["num_classes"], embed


# ---- a CPU test's size --------------------------------------------------------------------

def shrink(c: dict) -> dict:
    """timesformer_tiny's widths (dim 64, 4 heads of 16, 2 blocks) at 32²
    with patch 8 (16 patches a frame), 4 frames, B = 2."""
    c = dict(c, frames=4, frame_size=32, content=[18, 32], batch_size=2,
             dim=64, heads=4, mlp_dim=256, patch_size=8, layers=2)
    c["program"] = dict(c["program"], **{
        "model.backbone": "timesformer_tiny", "model.patch_size": 8,
        "data.fps": 4, "data.duration": 1, "data.frame_size": 32,
        "data.batch_size": 2})
    return c
