"""The published TimeSformer forward with divided space-time attention
(Bertasius, Wang and Torresani, arXiv:2102.05095: the authors'
``VisionTransformer.forward_features`` and ``Block.forward``), in plain
float32 PyTorch, for the tests of ``models/timesformer.py``.

It reads a dict of parameters named as the port's state dict, and keeps the
published token order: the CLS token, then the patches in (h w t) order,
time fastest, moved between the temporal and the spatial attention by the
published regroups. q, k and v are one fused product (the published
``qkv``) of the port's three projections stacked. Every product runs in
float32 with TF32 off (``float32_math``). Imports nothing of the port and
nothing of JAX.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

EPS = 1e-6  # the published layer_norm_eps


@contextlib.contextmanager
def float32_math():
    """TF32 off for matrix products and cuDNN convolutions."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _ln(x, P, name):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"],
                        P[name + ".bias"], EPS)


def _linear(x, P, name):
    return F.linear(x, P[name + ".weight"], P[name + ".bias"])


def attention(x, P, name, heads):
    """The published ``Attention``: x [B, N, C] → [B, N, C]."""
    B, N, C = x.shape
    parts = ("query", "key", "value")
    w = torch.cat([P[f"{name}.{p}.weight"] for p in parts])
    b = torch.cat([P[f"{name}.{p}.bias"] for p in parts])
    qkv = F.linear(x, w, b).reshape(B, N, 3, heads, C // heads).permute(
        2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = ((q @ k.transpose(-2, -1)) * (C // heads) ** -0.5).softmax(-1)
    return _linear((attn @ v).transpose(1, 2).reshape(B, N, C), P,
                   name + ".out")


def block(x, P, name, heads, B, T, W):
    """The published divided space-time ``Block``: x [B, 1 + (h w t), m]."""
    M = x.shape[-1]
    hw = (x.shape[1] - 1) // T
    # temporal: 'b (h w t) m -> (b h w) t m'
    xt = x[:, 1:].reshape(B * hw, T, M)
    res = attention(_ln(xt, P, name + ".temporal_norm"), P,
                    name + ".temporal_attn", heads).reshape(B, hw * T, M)
    xt = x[:, 1:] + _linear(res, P, name + ".temporal_fc")
    # spatial: the CLS token copied into every frame,
    # 'b (h w t) m -> (b t) (h w) m'
    init_cls = x[:, :1]
    cls = init_cls.repeat(1, T, 1).reshape(B * T, 1, M)
    xs = xt.reshape(B, hw, T, M).permute(0, 2, 1, 3).reshape(B * T, hw, M)
    res = attention(_ln(torch.cat((cls, xs), 1), P, name + ".norm1"), P,
                    name + ".attn", heads)
    cls = res[:, 0].reshape(B, T, M).mean(1, keepdim=True)
    # '(b t) (h w) m -> b (h w t) m'
    res = res[:, 1:].reshape(B, T, hw, M).permute(0, 2, 1, 3).reshape(
        B, hw * T, M)
    x = torch.cat((init_cls, xt), 1) + torch.cat((cls, res), 1)
    h = F.gelu(_linear(_ln(x, P, name + ".norm2"), P, name + ".mlp_fc1"))
    return x + _linear(h, P, name + ".mlp_fc2")


def logits(P, frames, heads: int, patch: int):
    """float32 frames [B, T, S, S, 3] → float32 logits [B, classes]."""
    B, T, S, _, C = frames.shape
    x = F.conv2d(frames.permute(0, 1, 4, 2, 3).reshape(B * T, C, S, S),
                 P["patch_embed.weight"], P["patch_embed.bias"], stride=patch)
    W = x.shape[-1]
    x = x.flatten(2).transpose(1, 2)  # [(b t), (h w), m]
    M = x.shape[-1]
    cls = P["cls_token"].reshape(1, 1, M).expand(B * T, 1, M)
    x = torch.cat((cls, x), 1) + P["pos_embed"]
    cls = x[:B, :1]
    # '(b t) n m -> (b n) t m', the time table, '(b n) t m -> b (n t) m'
    x = x[:, 1:].reshape(B, T, -1, M).permute(0, 2, 1, 3).reshape(-1, T, M)
    x = (x + P["time_embed"][:T]).reshape(B, -1, M)
    x = torch.cat((cls, x), 1)
    depth = len({k.split(".")[1] for k in P if k.startswith("blocks.")})
    for i in range(depth):
        x = block(x, P, f"blocks.{i}", heads, B, T, W)
    return _linear(_ln(x, P, "norm")[:, 0], P, "head")
