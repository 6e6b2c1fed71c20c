"""The yardstick's arithmetic: the H100's peaks, the least time for a
piece of work (``bound_s``), the operations and bytes each kernel's
function needs at its shapes, and the FLOPs a clip costs.

Peaks (NVIDIA's H100 SXM data sheet, dense): 3.35 TB/s of HBM, 989 TFLOP/s
bf16 on the tensor cores, 67 TFLOP/s float32 on the CUDA cores. The counts
are of the function, whatever implements it, so that a redesigned kernel is
read on the same work: each input byte read once and each output byte
written once, a multiply-add two operations. K2 is counted against the CUDA
cores' float32 rate (a depthwise 7×7 has no product for the tensor cores to
take), K3 and K4 against bf16's.

A ``Launch`` is one launch of a kernel family: its operations, bytes and
the peak its operations run at. An architecture's module
(``benchmark/architectures/``) lists the launches of one forward, or of
one training step, of its configurations at batch B, in the order the
program issues them, from the functions here.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark import architectures

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


# ---- each kernel function's work at its shapes ----------------------------------------

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


# ---- the model's FLOPs ------------------------------------------------------------------

def clip_flops(c: dict, train: bool) -> float:
    """FLOPs a clip costs: its forward when serving; forward and backward
    (twice the forward's, the first layer's input gradient left out, no
    recomputation) when training. The forward's and the first layer's
    FLOPs are the architecture's (``clip_flops`` of its module)."""
    f, first = architectures.get(c["architecture"]).clip_flops(c, train)
    return 3 * f - first if train else f
