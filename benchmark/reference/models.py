"""The two configurations' forwards, in plain PyTorch, as functions of a
parameter dict (``weights.param_spec``'s names) and of ``Products``.

- ``convnext_gru_logits``: ConvNeXt-T (Liu et al., arXiv:2201.03545): a 4×4
  stride-4 stem, LayerNorm, four stages of blocks (depthwise 7×7, LayerNorm,
  4× MLP with tanh GELU, layer scale, residual) with LayerNorm and a 2×2
  stride-2 convolution between them (flax's SAME padding, which at these
  sides pads nothing), the global mean and a LayerNorm; then a
  bidirectional GRU over the frames in float32, the projection of its two
  last states with ReLU, and the classifier MLP (ReLU, dropout) to the
  logits in float32.
- ``vivit_logits``: a factorised-encoder ViViT (Arnab et al.,
  arXiv:2103.15691): patches embedded by one product, a learned spatial
  position table, pre-norm transformer blocks (softmax attention, tanh-GELU
  MLP) over each frame's patches, a LayerNorm, the mean over patches, a
  temporal position table, the temporal blocks over the frames, a
  LayerNorm, the mean over frames and the head in float32.

Every activation is float32. ``prec`` computes the products the
configurations state in bf16 and rounds what the program keeps in bf16
(``Products.act``); the GRU and the last layer always take float32.
``ckpt`` recomputes each block in the backward (``torch.utils.checkpoint``),
so that a float32 step at the timed sizes fits the card; it changes no
value.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.products import FLOAT32, Products

LN_EPS = 1e-6


def layer_norm(x, P, name):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"],
                        P[name + ".bias"], LN_EPS)


def linear(prec: Products, x, P, name):
    return prec.linear(x, P[name + ".weight"], P[name + ".bias"])


def gelu(x):
    return F.gelu(x, approximate="tanh")


def dropout(h, rate, generator):
    """Inverted dropout, its mask drawn as the program draws it."""
    if generator is None or rate == 0.0:
        return h
    keep = 1.0 - rate
    mask = torch.bernoulli(torch.full(h.shape, keep, device=h.device),
                           generator=generator)
    return torch.where(mask.bool(), h / keep, torch.zeros_like(h))


def _run(block, x, ckpt):
    if ckpt and torch.is_grad_enabled():
        return checkpoint(block, x, use_reentrant=False)
    return block(x)


# ---- ConvNeXt-T + bi-GRU + MLP ------------------------------------------------

def _same(x, k, s):
    """flax's SAME padding of an NCHW tensor for a k-wide window at stride s."""
    def pads(n):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        return total // 2, total - total // 2

    (t, b), (l, r) = pads(x.shape[-2]), pads(x.shape[-1])
    return F.pad(x, (l, r, t, b)) if t or b or l or r else x


def _conv_nhwc(prec, x, P, name, k):
    y = prec.conv2d(_same(x.permute(0, 3, 1, 2), k, k), P[name + ".weight"],
                    P[name + ".bias"], stride=k)
    return y.permute(0, 2, 3, 1)


def convnext_block(P, name, prec):
    def block(x):
        C = x.shape[-1]
        w = P[name + ".dwconv.weight"].t().reshape(C, 1, 7, 7)
        y = prec.conv2d(x.permute(0, 3, 1, 2), w, P[name + ".dwconv.bias"],
                        padding=3, groups=C).permute(0, 2, 3, 1)
        y = layer_norm(y, P, name + ".norm")
        y = gelu(linear(prec, y, P, name + ".pwconv1"))
        y = linear(prec, y, P, name + ".pwconv2")
        return prec.act(x + y * P[name + ".gamma"])
    return block


def convnext_features(P, x, c, prec, ckpt=False):
    """[N, H, W, 3] → [N, dims[-1]]."""
    b = "backbone"
    x = layer_norm(_conv_nhwc(prec, x, P, f"{b}.stem_conv", 4), P,
                   f"{b}.stem_norm")
    for stage, depth in enumerate(c["depths"]):
        if stage > 0:
            x = layer_norm(x, P, f"{b}.downsample{stage}_norm")
            x = _conv_nhwc(prec, x, P, f"{b}.downsample{stage}_conv", 2)
        for blk in range(depth):
            x = _run(convnext_block(P, f"{b}.stage{stage}_block{blk}", prec),
                     x, ckpt)
    return layer_norm(x.mean(dim=(1, 2)), P, f"{b}.head_norm")


def gru_last(P, x, sfx, H, reverse):
    """The last state of one direction of the GRU over x [B, T, D]:
    r = σ(W_ir x + b_ir + W_hr h + b_hr), z likewise,
    n = tanh(W_in x + b_in + r ⊙ (W_hn h + b_hn)), h ← (1 − z) n + z h."""
    g = "temporal.gru"
    gi = FLOAT32.linear(x, P[f"{g}.weight_ih_l0{sfx}"], P[f"{g}.bias_ih_l0{sfx}"])
    w_hh, b_hh = P[f"{g}.weight_hh_l0{sfx}"], P[f"{g}.bias_hh_l0{sfx}"]
    h = x.new_zeros(x.shape[0], H)
    steps = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
    for t in steps:
        gh = FLOAT32.linear(h, w_hh, b_hh)
        r = torch.sigmoid(gi[:, t, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, t, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, t, 2 * H:] + r * gh[:, 2 * H:])
        h = (1 - z) * n + z * h
    return h


def convnext_gru_logits(P, frames, c, prec: Products = FLOAT32,
                        subsample: int = 1,
                        generator: Optional[torch.Generator] = None,
                        ckpt: bool = False):
    """Model-ready float32 frames [B, T, S, S, 3] → logits [B, classes].
    ``subsample``: keep every k-th frame (the model's own fold, used in
    training; serving hands over the folded frames). ``generator``: the
    dropout masks' source, in training."""
    if subsample > 1 and frames.shape[1] > c["subsample_threshold"]:
        frames = frames[:, ::subsample]
    B, T = frames.shape[:2]
    feats = convnext_features(P, frames.reshape(B * T, *frames.shape[2:]), c,
                              prec, ckpt).reshape(B, T, -1)
    H = c["temporal_hidden"]
    last = torch.cat([gru_last(P, feats, "", H, False),
                      gru_last(P, feats, "_reverse", H, True)], dim=-1)
    h = F.relu(FLOAT32.linear(last, P["temporal.proj.weight"],
                              P["temporal.proj.bias"]))
    h = dropout(F.relu(linear(prec, h, P, "fc1")), c["dropout"], generator)
    h = dropout(F.relu(linear(prec, h, P, "fc2")), c["dropout"], generator)
    return FLOAT32.linear(h, P["fc_out.weight"], P["fc_out.bias"])


# ---- ViViT ------------------------------------------------------------------------

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


def vivit_logits(P, frames, c, prec: Products = FLOAT32, ckpt: bool = False,
                 chunk: int = 64):
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


def logits(P, frames, c, prec: Products = FLOAT32, training=False,
           generator=None, ckpt=False):
    """The configuration's forward: serving (folded frames, no dropout) or
    training (the model's own fold, dropout from ``generator``)."""
    frames = prec.act(frames)
    if c["architecture"] == "vivit":
        return vivit_logits(P, frames, c, prec, ckpt)
    return convnext_gru_logits(
        P, frames, c, prec, subsample=c["frame_subsample"] if training else 1,
        generator=generator if training else None, ckpt=ckpt)
