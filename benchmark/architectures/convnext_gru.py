"""ConvNeXt per frame, a bidirectional GRU over the frames, and an MLP: the
port's flagship (``configs/flagship.json``).

- The reference forward (``logits``): ConvNeXt-T (Liu et al.,
  arXiv:2201.03545): a 4×4 stride-4 stem, LayerNorm, four stages of blocks
  (depthwise 7×7, LayerNorm, 4× MLP with tanh GELU, layer scale, residual)
  with LayerNorm and a 2×2 stride-2 convolution between them (flax's SAME
  padding, which at these sides pads nothing), the global mean and a
  LayerNorm; then a bidirectional GRU over the frames in float32, the
  projection of its two last states with ReLU, and the classifier MLP
  (ReLU, dropout) to the logits in float32.
- The parameters: ConvNeXt layer scales U(0.5, 1.5), so that no block is
  an identity. The GRU's ``bias_hh`` holds only its n gate's bias: the r
  and z parts are 0 and take no gradient (the program's flax-shaped cell
  has one bias per gate).
- The launches of K2 (the depthwise 7×7) and K3 (the block's LayerNorm →
  MLP → layer scale → residual) in one forward or training step at batch
  B, in the order the program issues them, and the clip's FLOPs.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from benchmark.counts import Launch, k2_fwd, k2_wgrad, k3_eval, k3_train
from benchmark.reference.models import _run, dropout, gelu, layer_norm, linear
from benchmark.reference.products import FLOAT32, Products
from benchmark.reference.weights import Spec, linear_spec, norm_spec


# ---- parameters ---------------------------------------------------------------------

def _gru_bias_hh(z, u, H):
    t = z * 0.1
    t[: 2 * H] = 0.0
    return t


LAWS = {"gru_bias_hh": _gru_bias_hh}


def param_spec(c: dict) -> Spec:
    dims, depths = c["dims"], c["depths"]
    spec: Spec = []
    b = "backbone"
    spec.append((f"{b}.stem_conv.weight", (dims[0], 3, 4, 4),
                 ("normal", 48 ** -0.5)))
    spec.append((f"{b}.stem_conv.bias", (dims[0],), ("normal", 0.1)))
    norm_spec(spec, f"{b}.stem_norm", dims[0])
    for stage, depth in enumerate(depths):
        if stage > 0:
            norm_spec(spec, f"{b}.downsample{stage}_norm", dims[stage - 1])
            spec.append((f"{b}.downsample{stage}_conv.weight",
                         (dims[stage], dims[stage - 1], 2, 2),
                         ("normal", (4 * dims[stage - 1]) ** -0.5)))
            spec.append((f"{b}.downsample{stage}_conv.bias", (dims[stage],),
                         ("normal", 0.1)))
        C = dims[stage]
        for blk in range(depth):
            n = f"{b}.stage{stage}_block{blk}"
            spec.append((f"{n}.gamma", (C,), ("uniform", 0.5, 1.5)))
            spec.append((f"{n}.dwconv.weight", (49, C), ("normal", 49 ** -0.5)))
            spec.append((f"{n}.dwconv.bias", (C,), ("normal", 0.1)))
            norm_spec(spec, f"{n}.norm", C)
            linear_spec(spec, f"{n}.pwconv1", C, 4 * C)
            linear_spec(spec, f"{n}.pwconv2", 4 * C, C)
    norm_spec(spec, f"{b}.head_norm", dims[-1])
    H, D = c["temporal_hidden"], dims[-1]
    g = "temporal.gru"
    for sfx in ("", "_reverse"):
        spec.append((f"{g}.weight_ih_l0{sfx}", (3 * H, D), ("normal", D ** -0.5)))
        spec.append((f"{g}.weight_hh_l0{sfx}", (3 * H, H), ("normal", H ** -0.5)))
        spec.append((f"{g}.bias_ih_l0{sfx}", (3 * H,), ("normal", 0.1)))
        spec.append((f"{g}.bias_hh_l0{sfx}", (3 * H,), ("gru_bias_hh", H)))
    linear_spec(spec, "temporal.proj", 2 * H, H)
    hid = c["classifier_hidden"]
    linear_spec(spec, "fc1", H, hid)
    linear_spec(spec, "fc2", hid, hid // 2)
    linear_spec(spec, "fc_out", hid // 2, c["num_classes"], c["logit_scale"])
    return spec


def frozen_mask(name: str, c: dict):
    """The GRU's ``bias_hh`` r and z parts take no gradient."""
    if name.startswith("temporal.gru.bias_hh"):
        H = c["temporal_hidden"]
        m = torch.ones(3 * H)
        m[:2 * H] = 0.0
        return m
    return None


# ---- the reference forward ------------------------------------------------------------

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


def logits(P, frames, c, prec: Products = FLOAT32, training: bool = False,
           generator: Optional[torch.Generator] = None, ckpt: bool = False):
    """Model-ready float32 frames [B, T, S, S, 3] → logits [B, classes].
    Training keeps every k-th frame (the model's own fold; serving hands
    over the folded frames) and draws the dropout masks from
    ``generator``."""
    k = c["frame_subsample"] if training else 1
    if k > 1 and frames.shape[1] > c["subsample_threshold"]:
        frames = frames[:, ::k]
    generator = generator if training else None
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


# ---- launches and FLOPs -------------------------------------------------------------------

def stages(c: dict):
    """(side, channels, blocks) of each stage at the configuration's frame
    side: the stem's stride 4 and each downsample's stride 2, SAME
    padding (a side rounds up)."""
    side = -(-c["frame_size"] // 4)
    out = []
    for i, (C, n) in enumerate(zip(c["dims"], c["depths"])):
        if i:
            side = -(-side // 2)
        out.append((side, C, n))
    return out


def frames_in_backbone(c: dict, train: bool) -> int:
    """Frames a clip sends through the backbone: serving folds them in the
    loader, training in the model."""
    T = c["frames"]
    if c.get("frame_subsample", 1) > 1 and T > c["subsample_threshold"]:
        return -(-T // c["frame_subsample"])
    return T


def k2_launches(c: dict, B: int, train: bool) -> List[Launch]:
    """K2's forward launches of one forward (training: also the dx launch of
    each block, the forward's function on the gradient)."""
    N = B * frames_in_backbone(c, train)
    per = [k2_fwd(N, s, s, C) for s, C, n in stages(c) for _ in range(n)]
    return per + per if train else per


def k2_wgrad_launches(c: dict, B: int) -> List[Launch]:
    N = B * frames_in_backbone(c, True)
    return [k2_wgrad(N, s, s, C) for s, C, n in stages(c) for _ in range(n)]


def k3_launches(c: dict, B: int, train: bool) -> List[Launch]:
    N = B * frames_in_backbone(c, train)
    fn = k3_train if train else k3_eval
    return [fn(N * s * s, C) for s, C, n in stages(c) for _ in range(n)]


def clip_flops(c: dict, train: bool) -> tuple:
    """(FLOPs of one clip's forward, FLOPs of its first layer)."""
    T = frames_in_backbone(c, train)
    st = stages(c)
    s0, c0, _ = st[0]
    stem = 2.0 * s0 * s0 * c0 * 4 * 4 * 3
    f = stem
    prev = None
    for s, C, n in st:
        if prev is not None:
            f += 2.0 * s * s * C * 4 * prev
        f += n * (2.0 * 49 * s * s * C + 16.0 * s * s * C * C)
        prev = C
    f *= T
    H, D = c["temporal_hidden"], c["dims"][-1]
    f += 2 * T * 2.0 * 3 * H * (D + H)          # both directions
    hid = c["classifier_hidden"]
    f += 2.0 * (2 * H * H + H * hid + hid * hid // 2 + hid // 2 * c["num_classes"])
    return f, stem * T


# ---- a CPU test's size --------------------------------------------------------------------

def shrink(c: dict) -> dict:
    """32² frames (12 frames, folded to 6), B = 2, the published widths."""
    c = dict(c, frames=12, frame_size=32, content=[18, 32], batch_size=2)
    c["program"] = {"data.fps": 4, "data.duration": 3, "data.frame_size": 32,
                    "data.batch_size": 2}
    return c
