"""K3: the fused ConvNeXt-block MLP, inference variant.

``out = x + γ ⊙ (GELU(LN(y)·W1 + b1)·W2 + b2)`` over rows of [M, C].

Replaces the TPU kernel
``vision_collision_detection_tpu/ops/convnext_mlp_pallas.py``
``convnext_mlp_block`` (``_eval_kernel``, math ``_ln_mlp``). The CUDA
kernel is ``ops/csrc/convnext_mlp.cu``. Its bound on the H100 is operations:
16·M·C² flops per launch, ≈ 92 GFLOP per launch on the flagship forward
at B=8 and ≈ 1.66 TFLOP over the 18 launches, ≈ 1.7 ms at 989 TFLOP/s bf16.

Numerics, shared by the kernel and the plain version: LN with eps 1e-6 and
float32 two-pass statistics; t = LN(y) rounded to bf16; products on bf16
with float32 accumulation; h_pre = t·W1 + b1 rounded to bf16; GELU (tanh or
erf) in float32, rounded to bf16; the residual added in float32 and cast to
x's dtype. W1 [C, 4C] and W2 [4C, C] are in the flax (in, out) layout.
"""

from __future__ import annotations

import math

import torch

from vision_collision_detection_tpu_torch.ops import _build

LN_EPS = 1e-6
# The widths the kernel is compiled for: every stage of convnext tiny, base
# and large.
KERNEL_DIMS = (96, 128, 192, 256, 384, 512, 768, 1024, 1536)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def gelu_f32(v: torch.Tensor, approximate: bool) -> torch.Tensor:
    """GELU in float32. The kernel evaluates the tanh form as v·σ(2u),
    the same function with other roundings (relative difference ~1e-6)."""
    if approximate:
        inner = math.sqrt(2.0 / math.pi) * (v + 0.044715 * (v * v * v))
        return v * (0.5 * (1.0 + torch.tanh(inner)))
    return v * (torch.erf(v / math.sqrt(2.0)) + 1.0) / 2.0


def _check(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma):
    C = x.shape[-1]
    if y.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} differ")
    expect = {"ln_w": (ln_w, (C,)), "ln_b": (ln_b, (C,)),
              "w1": (w1, (C, 4 * C)), "b1": (b1, (4 * C,)),
              "w2": (w2, (4 * C, C)), "b2": (b2, (C,)),
              "gamma": (gamma, (C,))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def convnext_mlp_plain(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma,
                       approximate: bool) -> torch.Tensor:
    """Plain PyTorch version of K3, step by step with the kernel's roundings."""
    _check(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma)
    C = x.shape[-1]
    yf = y.reshape(-1, C).to(torch.float32)
    mu = yf.mean(-1, keepdim=True)
    var = (yf - mu).square().mean(-1, keepdim=True)
    xhat = (yf - mu) * torch.rsqrt(var + LN_EPS)
    t = (xhat * ln_w.float() + ln_b.float()).to(torch.bfloat16)
    acc1 = torch.matmul(t.float(), w1.to(torch.bfloat16).float())
    h_pre = (acc1 + b1.float()).to(torch.bfloat16)
    h = gelu_f32(h_pre.float(), approximate).to(torch.bfloat16)
    m = torch.matmul(h.float(), w2.to(torch.bfloat16).float()) + b2.float()
    out = x.reshape(-1, C).to(torch.float32) + gamma.float() * m
    return out.to(x.dtype).reshape(x.shape)


def convnext_mlp(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma,
                 approximate: bool) -> torch.Tensor:
    """K3. x (shortcut) and y (dwconv output): [..., C]. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel. Parameters may be
    float32; they are cast to the kernel's types here (W1, W2 to bf16,
    the rest to float32). Returns [..., C] in x's dtype."""
    if x.device.type == "cpu":
        return convnext_mlp_plain(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma,
                                  approximate)
    _check(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma)
    C = x.shape[-1]
    if x.dtype not in _DTYPE_CODE or y.dtype != x.dtype:
        raise ValueError(
            f"convnext_mlp kernel takes x, y both bf16 or both float32, got "
            f"{x.dtype}, {y.dtype}")
    if C not in KERNEL_DIMS:
        raise ValueError(
            f"convnext_mlp kernel takes C in {KERNEL_DIMS}, got {C}")
    f32 = [t.to(torch.float32).contiguous() for t in (ln_w, ln_b, b1, b2, gamma)]
    ln_w, ln_b, b1, b2, gamma = f32
    w1 = w1.to(torch.bfloat16).contiguous()
    w2 = w2.to(torch.bfloat16).contiguous()
    # x, y, W1 and W2 are read 16 bytes at a time
    for t, name in ((x, "x"), (y, "y"), (w1, "w1"), (w2, "w2")):
        _build.require_cuda(t, name, align=16)
    for t, name in ((ln_w, "ln_w"), (ln_b, "ln_b"), (b1, "b1"), (b2, "b2"),
                    (gamma, "gamma")):
        _build.require_cuda(t, name)
    M = x.numel() // C
    out = torch.empty_like(x)
    err = _build.lib().vcd_convnext_mlp(
        x.data_ptr(), y.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        gamma.data_ptr(), out.data_ptr(), M, C, int(bool(approximate)),
        _DTYPE_CODE[x.dtype], _build.stream_ptr(x.device))
    _build.check(err, "vcd_convnext_mlp")
    convnext_mlp.launches += 1
    return out


convnext_mlp.launches = 0
