"""The yardstick's arithmetic: the H100's peaks, the least time for a
piece of work (``bound_s``), the operations and bytes each kernel's
function needs at its shapes, and the model's FLOPs per clip.

Peaks (NVIDIA's H100 SXM data sheet, dense): 3.35 TB/s of HBM, 989 TFLOP/s
bf16 on the tensor cores, 67 TFLOP/s float32 on the CUDA cores. The counts
are of the function, whatever implements it, so that a redesigned kernel is
read on the same work: each input byte read once and each output byte
written once, a multiply-add two operations. K2 is counted against the CUDA
cores' float32 rate (a depthwise 7×7 has no product for the tensor cores to
take), K3 and K4 against bf16's.

A ``Launch`` is one launch of a kernel family: its operations, bytes and
the peak its operations run at. The lists below give the launches of one
forward, or of one training step, of a configuration at batch B, in the
order the program issues them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
BF16 = 2  # bytes an element


@dataclass(frozen=True)
class Launch:
    ops: float
    bytes: float
    peak: float

    def bound_s(self) -> float:
        return bound_s(self.bytes, self.ops, self.peak)


def bound_s(n_bytes: float, n_ops: float, peak_ops: float) -> float:
    """The least time: the larger of bytes over the HBM rate and operations
    over ``peak_ops``."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / peak_ops)


# ---- ConvNeXt ---------------------------------------------------------------------

def convnext_stages(c: dict):
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


def k2_fwd(N, H, W, C) -> Launch:
    """Depthwise 7×7 + bias: 49 multiply-adds an output; x read, y written."""
    return Launch(98.0 * N * H * W * C, BF16 * (2 * N * H * W * C + 50 * C),
                  F32_FLOPS)


def k2_wgrad(N, H, W, C) -> Launch:
    """dw[49, C] = Σ x·g over every pixel: x and g read, float32 dw written."""
    return Launch(98.0 * N * H * W * C, BF16 * 2 * N * H * W * C + 4 * 49 * C,
                  F32_FLOPS)


def k3_eval(M, C) -> Launch:
    """x + γ⊙(GELU(LN(y)·W1 + b1)·W2 + b2) over [M, C]: two products of
    2·M·C·4C; x and y read, out written, the weights read once."""
    return Launch(16.0 * M * C * C, BF16 * (3 * M * C + 8 * C * C + 7 * C),
                  BF16_FLOPS)


def k3_train(M, C) -> Launch:
    """K3's eval function, also writing what the backward reads: t [M, C],
    h_pre [M, 4C] and m [M, C], bf16."""
    return Launch(16.0 * M * C * C,
                  BF16 * (3 * M * C + 6 * M * C + 8 * C * C + 7 * C),
                  BF16_FLOPS)


def k2_launches(c: dict, B: int, train: bool) -> List[Launch]:
    """K2's forward launches of one forward (training: also the dx launch of
    each block, the forward's function on the gradient)."""
    N = B * frames_in_backbone(c, train)
    per = [k2_fwd(N, s, s, C) for s, C, n in convnext_stages(c)
           for _ in range(n)]
    return per + per if train else per


def k2_wgrad_launches(c: dict, B: int) -> List[Launch]:
    N = B * frames_in_backbone(c, True)
    return [k2_wgrad(N, s, s, C) for s, C, n in convnext_stages(c)
            for _ in range(n)]


def k3_launches(c: dict, B: int, train: bool) -> List[Launch]:
    N = B * frames_in_backbone(c, train)
    fn = k3_train if train else k3_eval
    return [fn(N * s * s, C) for s, C, n in convnext_stages(c) for _ in range(n)]


def frames_in_backbone(c: dict, train: bool) -> int:
    """Frames a clip sends through the backbone: serving folds them in the
    loader, training in the model; a ViViT keeps all."""
    T = c["frames"]
    if c.get("frame_subsample", 1) > 1 and T > c["subsample_threshold"]:
        return -(-T // c["frame_subsample"])
    return T


# ---- K4 -----------------------------------------------------------------------------

def k4_fwd(N, S, Hh, D, lse: bool) -> Launch:
    """o = softmax(q·kᵀ·scale)·v for N·Hh sequences: 4·S²·D operations;
    q, k, v read and o written (and the float32 log-sum-exp in training)."""
    n = N * Hh
    return Launch(4.0 * S * S * D * n, n * (BF16 * 4 * S * D + (4 * S if lse else 0)),
                  BF16_FLOPS)


def k4_dkv(N, S, Hh, D) -> Launch:
    """dK, dV: the logits and do·vᵀ again, p·do and ds·q: 8·S²·D; q, k, v,
    do, lse and di read, dk and dv written."""
    n = N * Hh
    return Launch(8.0 * S * S * D * n, n * (BF16 * 6 * S * D + 8 * S), BF16_FLOPS)


def k4_dq(N, S, Hh, D) -> Launch:
    """dQ: the logits, do·vᵀ and ds·k: 6·S²·D; q, k, v, do, lse, di read,
    dq written."""
    n = N * Hh
    return Launch(6.0 * S * S * D * n, n * (BF16 * 5 * S * D + 8 * S), BF16_FLOPS)


def k4_di(N, S, Hh, D) -> Launch:
    """di = Σ o⊙do a row: o and do read, float32 di written."""
    n = N * Hh
    return Launch(2.0 * S * D * n, n * (BF16 * 2 * S * D + 4 * S), BF16_FLOPS)


def vivit_tokens(c: dict) -> int:
    return (c["frame_size"] // c["patch_size"]) ** 2


def k4_launches(c: dict, B: int, train: bool) -> List[Launch]:
    """K4's launches in one forward (training: and one backward) of the
    spatial blocks, over B·T sequences of the frame's tokens."""
    N, S, Hh = B * c["frames"], vivit_tokens(c), c["heads"]
    D = c["dim"] // Hh
    L = c["spatial_layers"]
    if not train:
        return [k4_fwd(N, S, Hh, D, False)] * L
    return ([k4_fwd(N, S, Hh, D, True)] * L + [k4_di(N, S, Hh, D)] * L
            + [k4_dkv(N, S, Hh, D)] * L + [k4_dq(N, S, Hh, D)] * L)


# ---- the model's FLOPs ------------------------------------------------------------------

def convnext_gru_flops(c: dict, train: bool) -> tuple:
    """(FLOPs of one clip's forward, FLOPs of its first layer): products
    and convolutions only, two a multiply-add."""
    T = frames_in_backbone(c, train)
    stages = convnext_stages(c)
    s0, c0, _ = stages[0]
    stem = 2.0 * s0 * s0 * c0 * 4 * 4 * 3
    f = stem
    prev = None
    for s, C, n in stages:
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


def vivit_flops(c: dict) -> tuple:
    T, S, d, mlp = c["frames"], vivit_tokens(c), c["dim"], c["mlp_dim"]
    p = c["patch_size"]
    embed = 2.0 * T * S * 3 * p * p * d
    block = lambda n, seq: 2.0 * n * (4 * d * d + 2 * d * mlp) + 4.0 * seq * seq * d * (n // seq)  # noqa: E731
    f = embed + c["spatial_layers"] * block(T * S, S)
    f += c["temporal_layers"] * block(T, T)
    f += 2.0 * d * c["num_classes"]
    return f, embed


def clip_flops(c: dict, train: bool) -> float:
    """FLOPs a clip costs: its forward when serving; forward and backward
    (twice the forward's, the first layer's input gradient left out, no
    recomputation) when training."""
    f, first = (vivit_flops(c) if c["architecture"] == "vivit"
                else convnext_gru_flops(c, train))
    return 3 * f - first if train else f
