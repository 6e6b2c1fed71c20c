"""The factorised-encoder ViViT (Arnab et al., arXiv:2103.15691): the scaled
ViViT of ``configs/vivit_small.json``.

- The reference forward (``logits``): patches embedded by one product, a
  learned spatial position table, pre-norm transformer blocks (softmax
  attention, tanh-GELU MLP) over each frame's patches, a LayerNorm, the
  mean over patches, a temporal position table, the temporal blocks over
  the frames, a LayerNorm, the mean over frames and the head in float32.
  No dropout, and every frame is kept in training too.
- The parameters: position tables N(0, 0.02²); no part is frozen.
- The launches of K4 (flash self-attention, the spatial blocks) in one
  forward or training step at batch B, and the clip's FLOPs.
"""

from __future__ import annotations

from typing import List

import torch

from benchmark.counts import Launch, k4_di, k4_dkv, k4_dq, k4_fwd
from benchmark.reference.models import _run, gelu, layer_norm, linear
from benchmark.reference.products import FLOAT32, Products
from benchmark.reference.weights import Spec, linear_spec, norm_spec


# ---- parameters ---------------------------------------------------------------------

def _block_spec(spec: Spec, name: str, dim: int, mlp: int):
    norm_spec(spec, f"{name}.norm1", dim)
    for p in ("query", "key", "value", "out"):
        linear_spec(spec, f"{name}.attn.{p}", dim, dim)
    norm_spec(spec, f"{name}.norm2", dim)
    linear_spec(spec, f"{name}.mlp_fc1", dim, mlp)
    linear_spec(spec, f"{name}.mlp_fc2", mlp, dim)


def param_spec(c: dict) -> Spec:
    dim, P = c["dim"], c["patch_size"]
    spec: Spec = [
        ("patch_embed.weight", (dim, 3, P, P), ("normal", (3 * P * P) ** -0.5)),
        ("patch_embed.bias", (dim,), ("normal", 0.1)),
        ("spatial_pos", (tokens(c), dim), ("normal", 0.02)),
    ]
    for i in range(c["spatial_layers"]):
        _block_spec(spec, f"spatial_{i}", dim, c["mlp_dim"])
    norm_spec(spec, "spatial_norm", dim)
    spec.append(("temporal_pos", (c["max_frames"], dim), ("normal", 0.02)))
    for i in range(c["temporal_layers"]):
        _block_spec(spec, f"temporal_{i}", dim, c["mlp_dim"])
    norm_spec(spec, "temporal_norm", dim)
    linear_spec(spec, "head", dim, c["num_classes"], c["logit_scale"])
    return spec


def frozen_mask(name: str, c: dict):
    return None


# ---- the reference forward ------------------------------------------------------------

def attention(prec, q, k, v, chunk):
    """softmax(q·kᵀ/√d)·v over [N, H, S, d], ``chunk`` sequences at a time;
    the logits are float32 (as K4 keeps them), their operands ``prec``'s."""
    scale = q.shape[-1] ** -0.5
    outs = []
    for i in range(0, q.shape[0], chunk):
        w = torch.matmul(prec.q(q[i:i + chunk]),
                         prec.q(k[i:i + chunk].transpose(-1, -2)))
        outs.append(prec.matmul(torch.softmax(w * scale, dim=-1),
                                v[i:i + chunk]))
    return torch.cat(outs)


def transformer_block(P, name, heads, prec, chunk):
    def block(x):
        N, S, D = x.shape
        h = layer_norm(x, P, name + ".norm1")
        q, k, v = (linear(prec, h, P, f"{name}.attn.{p}").view(
            N, S, heads, D // heads).transpose(1, 2)
            for p in ("query", "key", "value"))
        o = attention(prec, q, k, v, chunk).transpose(1, 2).reshape(N, S, D)
        x = prec.act(x + linear(prec, o, P, name + ".attn.out"))
        h = gelu(linear(prec, layer_norm(x, P, name + ".norm2"), P,
                        name + ".mlp_fc1"))
        return prec.act(x + linear(prec, h, P, name + ".mlp_fc2"))
    return block


def logits(P, frames, c, prec: Products = FLOAT32, training: bool = False,
           generator=None, ckpt: bool = False, chunk: int = 64):
    """Model-ready float32 frames [B, T, S, S, 3] → logits [B, classes]."""
    B, T, H, W, C = frames.shape
    p, D = c["patch_size"], c["dim"]
    patches = frames.reshape(B * T, H // p, p, W // p, p, C).permute(
        0, 1, 3, 2, 4, 5).reshape(B * T, (H // p) * (W // p), p * p * C)
    w = P["patch_embed.weight"].permute(2, 3, 1, 0).reshape(p * p * C, D)
    x = prec.act(prec.matmul(patches, w) + P["patch_embed.bias"]
                 + P["spatial_pos"])
    for i in range(c["spatial_layers"]):
        x = _run(transformer_block(P, f"spatial_{i}", c["heads"], prec, chunk),
                 x, ckpt)
    x = layer_norm(x, P, "spatial_norm").mean(dim=1).reshape(B, T, D)
    x = prec.act(x + P["temporal_pos"][:T])
    for i in range(c["temporal_layers"]):
        x = transformer_block(P, f"temporal_{i}", c["heads"], prec, chunk)(x)
    x = layer_norm(x, P, "temporal_norm").mean(dim=1)
    return FLOAT32.linear(x, P["head.weight"], P["head.bias"])


# ---- launches and FLOPs -------------------------------------------------------------------

def tokens(c: dict) -> int:
    """Patches a frame."""
    return (c["frame_size"] // c["patch_size"]) ** 2


def k4_launches(c: dict, B: int, train: bool) -> List[Launch]:
    """K4's launches in one forward (training: and one backward) of the
    spatial blocks, over B·T sequences of the frame's tokens."""
    N, S, Hh = B * c["frames"], tokens(c), c["heads"]
    D = c["dim"] // Hh
    L = c["spatial_layers"]
    if not train:
        return [k4_fwd(N, S, Hh, D, False)] * L
    return ([k4_fwd(N, S, Hh, D, True)] * L + [k4_di(N, S, Hh, D)] * L
            + [k4_dkv(N, S, Hh, D)] * L + [k4_dq(N, S, Hh, D)] * L)


def clip_flops(c: dict, train: bool) -> tuple:
    """(FLOPs of one clip's forward, FLOPs of its patch embedding); every
    frame is kept in training too."""
    T, S, d, mlp = c["frames"], tokens(c), c["dim"], c["mlp_dim"]
    p = c["patch_size"]
    embed = 2.0 * T * S * 3 * p * p * d
    block = lambda n, seq: 2.0 * n * (4 * d * d + 2 * d * mlp) + 4.0 * seq * seq * d * (n // seq)  # noqa: E731
    f = embed + c["spatial_layers"] * block(T * S, S)
    f += c["temporal_layers"] * block(T, T)
    f += 2.0 * d * c["num_classes"]
    return f, embed


# ---- a CPU test's size --------------------------------------------------------------------

def shrink(c: dict) -> dict:
    """vivit_tiny's widths at 28² (4 tokens a frame, patch 14), 4 frames,
    B = 2."""
    c = dict(c, frames=4, frame_size=28, content=[16, 28], batch_size=2,
             dim=64, heads=4, mlp_dim=256, spatial_layers=2, temporal_layers=1)
    c["program"] = dict(c["program"], **{
        "model.backbone": "vivit_tiny", "data.fps": 4, "data.duration": 1,
        "data.frame_size": 28, "data.batch_size": 2})
    return c
