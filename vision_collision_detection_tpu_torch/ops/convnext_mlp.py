"""K3: the fused ConvNeXt-block MLP, ``out = x + γ ⊙ (GELU(LN(y)·W1 + b1)·W2 + b2)``
over rows of [M, C], with its gradient.

Replaces the TPU kernels of
``vision_collision_detection_tpu/ops/convnext_mlp_pallas.py``
``convnext_mlp_block`` (math ``_ln_mlp``), wired into ``jax.custom_vjp``
there and into the ``torch.autograd.Function`` ``_ConvNeXtMLP`` here. Both
variants share each kernel, and ``route`` picks one of three: bf16 or
float32 activations at the widths ``WGMMA_DIMS`` (convnext tiny's, base's
and large's up to 768) take the Hopper kernel
``ops/csrc/convnext_mlp_wgmma.cu`` (wgmma, TMA-fed weight tiles in
nn.Linear's own layout, a persistent block of 128 rows up to C = 256 and of
64 rows shared by two warpgroups above; bf16 rows of y arrive by TMA and
are normalised in the kernel, float32 ones go through a LayerNorm pass
whose bf16 t the kernel loads instead); bf16 or float32 at
``WIDE_DIMS`` (base's and large's last stage, 1024 and 1536) take
``ops/csrc/convnext_mlp_wide.cu``, the chain split into three launches (a
LayerNorm row kernel, then the two products as persistent wgmma/TMA GEMMs
with the bias, GELU and residual in their epilogues; t and h through
scratch, bf16 in both dtypes; float32 y, x and out read and written only
by the LayerNorm and the second product's epilogue) that read the weights
in nn.Linear's layout too. The ``mma.sync`` kernel
``ops/csrc/convnext_mlp.cu``, which reads the weights in the flax layout,
serves no width of ``KERNEL_DIMS`` now; it stays compiled as the
yardstick the card's checks time.

- **eval** (``_eval_kernel``): out only. Its bound on the H100 in bf16 is
  operations: 16·M·C² flops per launch, ≈ 92 GFLOP per launch on the
  flagship forward at B=8 and ≈ 1.66 TFLOP over the 18 launches, ≈ 1.7 ms
  at 989 TFLOP/s bf16. In float32 x, y and out take 12 bytes a
  row-channel: bytes bound it at C = 96 and 192 (≈ 2.1 ms over the 18).
- **train** (``_train_kernel``): the same out, and the tensors the backward
  needs, all bf16: t = LN(y) [M, C], h_pre = t·W1 + b1 [M, 4C] and
  m = h·W2 + b2 [M, C] (out uses the float32 m; only the saved copy is
  rounded). Its bound is bytes over a training step: 18 bytes per
  row-channel (x, y, out, t, m at 2 each and h_pre at 8), ≈ 7.7 GB over the
  18 launches at B=8, ≈ 2.3 ms at 3.35 TB/s, against the eval kernel's
  ≈ 1.7 ms of flops (per stage: bytes at C = 96 and 192, operations at 384
  and 768).

The backward (``convnext_mlp_bwd``) is the JAX ``_bwd`` written in torch
ops, with its roundings: the four products take bf16 operands and give
float32 results (``torch.mm(..., out_dtype=torch.float32)`` on the card,
float32 products of the bf16 values on the CPU), and the LayerNorm
backward recomputes its float32 statistics from y.

Numerics of the forward, shared by the kernels and the plain versions: LN
with eps 1e-6 and float32 two-pass statistics; t = LN(y) rounded to bf16;
products on bf16 with float32 accumulation; h_pre = t·W1 + b1 rounded to
bf16; GELU (tanh or erf) in float32, rounded to bf16; the residual added
in float32 and cast to x's dtype. W1 [C, 4C] and W2 [4C, C] are in the flax
(in, out) layout. The wide kernel's three stages each have a plain version
(``ln_stage_plain``, ``up_stage_plain``, ``down_stage_plain``, which
compose into the whole) and a wrapper that launches that stage alone
(``ln_stage``, ``up_stage``, ``down_stage``), so that the card's checks
can hold each launch against its own plain version.
"""

from __future__ import annotations

import functools
import math

import torch

from vision_collision_detection_tpu_torch.ops import _build

LN_EPS = 1e-6
# The widths the kernel is compiled for: every stage of convnext tiny, base
# and large.
KERNEL_DIMS = (96, 128, 192, 256, 384, 512, 768, 1024, 1536)
# The widths of the Hopper kernel (bf16 and float32 activations).
WGMMA_DIMS = (96, 128, 192, 256, 384, 512, 768)
# The widths of the split wgmma kernel (bf16 and float32 activations).
WIDE_DIMS = (1024, 1536)
# ``vcd_convnext_mlp_wide``'s stages, as bits: LN, the first product with
# its epilogue, the second with its epilogue.
WIDE_LN, WIDE_UP, WIDE_DOWN = 1, 2, 4
WIDE_ALL = WIDE_LN | WIDE_UP | WIDE_DOWN
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu_f32(v: torch.Tensor, approximate: bool) -> torch.Tensor:
    """GELU in float32. The kernel evaluates the tanh form as v·σ(2u),
    the same function with other roundings (relative difference ~1e-6)."""
    if approximate:
        inner = _SQRT_2_OVER_PI * (v + 0.044715 * (v * v * v))
        return v * (0.5 * (1.0 + torch.tanh(inner)))
    return v * (torch.erf(v / math.sqrt(2.0)) + 1.0) / 2.0


def gelu_grad_f32(v: torch.Tensor, approximate: bool) -> torch.Tensor:
    """d GELU / dv in float32, for the form ``gelu_f32`` computes."""
    if approximate:
        th = torch.tanh(_SQRT_2_OVER_PI * (v + 0.044715 * (v * v * v)))
        du = _SQRT_2_OVER_PI * (1.0 + 3 * 0.044715 * (v * v))
        return 0.5 * (1.0 + th) + 0.5 * v * (1.0 - th * th) * du
    cdf = (torch.erf(v / math.sqrt(2.0)) + 1.0) / 2.0
    return cdf + v * torch.exp(-0.5 * v * v) / math.sqrt(2.0 * math.pi)


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


def _ln_stats(yf: torch.Tensor):
    """(mean, 1/std) of float32 rows [M, C], each [M, 1], two passes."""
    mu = yf.mean(-1, keepdim=True)
    var = (yf - mu).square().mean(-1, keepdim=True)
    return mu, torch.rsqrt(var + LN_EPS)


def _plain_parts(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma, approximate):
    """The kernel's arithmetic step by step: (out [..., C], t, h_pre bf16
    and m float32, each [M, ·])."""
    _check(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma)
    C = x.shape[-1]
    yf = y.reshape(-1, C).to(torch.float32)
    mu, rstd = _ln_stats(yf)
    t = ((yf - mu) * rstd * ln_w.float() + ln_b.float()).to(torch.bfloat16)
    acc1 = torch.matmul(t.float(), w1.to(torch.bfloat16).float())
    h_pre = (acc1 + b1.float()).to(torch.bfloat16)
    h = gelu_f32(h_pre.float(), approximate).to(torch.bfloat16)
    m = torch.matmul(h.float(), w2.to(torch.bfloat16).float()) + b2.float()
    out = x.reshape(-1, C).to(torch.float32) + gamma.float() * m
    return out.to(x.dtype).reshape(x.shape), t, h_pre, m


def convnext_mlp_plain(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma,
                       approximate: bool) -> torch.Tensor:
    """Plain PyTorch version of the eval kernel, step by step with its
    roundings."""
    return _plain_parts(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma,
                        approximate)[0]


def convnext_mlp_train_plain(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma,
                             approximate: bool):
    """Plain PyTorch version of the train kernel: (out [..., C], t [M, C],
    h_pre [M, 4C], m [M, C]), the last three bf16."""
    out, t, h_pre, m = _plain_parts(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma,
                                    approximate)
    return out, t, h_pre, m.to(torch.bfloat16)


def ln_stage_plain(y, ln_w, ln_b):
    """The wide kernel's first stage: t = LN(y) rounded to bf16, [M, C]."""
    C = y.shape[-1]
    yf = y.reshape(-1, C).to(torch.float32)
    mu, rstd = _ln_stats(yf)
    return ((yf - mu) * rstd * ln_w.float() + ln_b.float()).to(torch.bfloat16)


def up_stage_plain(t, w1, b1, approximate: bool):
    """Its second: (h_pre, h) [M, 4C] bf16 from t [M, C] and W1 [C, 4C]."""
    acc1 = torch.matmul(t.float(), w1.to(torch.bfloat16).float())
    h_pre = (acc1 + b1.float()).to(torch.bfloat16)
    return h_pre, gelu_f32(h_pre.float(), approximate).to(torch.bfloat16)


def down_stage_plain(h, x, w2, b2, gamma):
    """Its third: (out [..., C] in x's dtype, m [M, C] float32) from
    h [M, 4C], the residual x and W2 [4C, C]."""
    C = x.shape[-1]
    m = torch.matmul(h.float(), w2.to(torch.bfloat16).float()) + b2.float()
    out = x.reshape(-1, C).to(torch.float32) + gamma.float() * m
    return out.to(x.dtype).reshape(x.shape), m


def route(dtype: torch.dtype, C: int) -> str:
    """Which kernel a CUDA call takes: ``"wgmma"`` (the Hopper kernel) for
    bf16 or float32 activations at a width of ``WGMMA_DIMS``, ``"wide"``
    (the split wgmma kernel) for either at ``WIDE_DIMS``, else ``"mma"``."""
    if C in WGMMA_DIMS:
        return "wgmma"
    if C in WIDE_DIMS:
        return "wide"
    return "mma"


def kernel_weights(w1: torch.Tensor, w2: torch.Tensor, kernel_route: str):
    """W1 [C, 4C] and W2 [4C, C] (the flax layout, as the public functions
    take them) as the kernel of ``kernel_route`` reads them, contiguous
    bf16: ``"wgmma"`` and ``"wide"`` in nn.Linear's layout, W1 as [4C, C]
    and W2 as [C, 4C]; ``"mma"`` in the flax layout. A block passes
    ``pwconv1.weight.t()``: for the Hopper kernels that view's own storage
    is the layout, so only a dtype cast (none for bf16 weights) is made."""
    if kernel_route in ("wgmma", "wide"):
        w1, w2 = w1.t(), w2.t()
    return (w1.to(torch.bfloat16).contiguous(),
            w2.to(torch.bfloat16).contiguous())


def _kernel_operands(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma):
    """Check a kernel call and cast the parameters to the kernel's types
    (W1, W2 to contiguous bf16 in its layout, the rest to float32)."""
    _check(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma)
    C = x.shape[-1]
    if x.dtype not in _DTYPE_CODE or y.dtype != x.dtype:
        raise ValueError(
            f"convnext_mlp kernel takes x, y both bf16 or both float32, got "
            f"{x.dtype}, {y.dtype}")
    if C not in KERNEL_DIMS:
        raise ValueError(
            f"convnext_mlp kernel takes C in {KERNEL_DIMS}, got {C}")
    ln_w, ln_b, b1, b2, gamma = [t.to(torch.float32).contiguous()
                                 for t in (ln_w, ln_b, b1, b2, gamma)]
    w1, w2 = kernel_weights(w1, w2, route(x.dtype, C))
    # x, y, W1 and W2 are read 16 bytes at a time
    for t, name in ((x, "x"), (y, "y"), (w1, "w1"), (w2, "w2")):
        _build.require_cuda(t, name, align=16)
    for t, name in ((ln_w, "ln_w"), (ln_b, "ln_b"), (b1, "b1"), (b2, "b2"),
                    (gamma, "gamma")):
        _build.require_cuda(t, name)
    ptrs = [t.data_ptr() for t in (x, y, ln_w, ln_b, w1, b1, w2, b2, gamma)]
    # the casts above must outlive the launch: hand them back with the pointers
    return ptrs, (ln_w, ln_b, w1, b1, w2, b2, gamma), x.numel() // C, C


def _launch_eval(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma, approximate):
    """The eval kernel on CUDA tensors."""
    ptrs, _keep, M, C = _kernel_operands(x, y, ln_w, ln_b, w1, b1, w2, b2,
                                         gamma)
    out = torch.empty_like(x)
    stream = _build.stream_ptr(x.device)
    kernel_route = route(x.dtype, C)
    if kernel_route == "wgmma":
        # float32 activations: t is the LayerNorm pass's output, scratch
        # from the caching allocator
        t = (torch.empty(M, C, dtype=torch.bfloat16, device=x.device)
             if x.dtype == torch.float32 else None)
        err = _build.lib().vcd_convnext_mlp_wgmma(
            *ptrs, out.data_ptr(), None if t is None else t.data_ptr(), None,
            None, M, C, int(bool(approximate)), _DTYPE_CODE[x.dtype], stream)
        _build.check(err, "vcd_convnext_mlp_wgmma")
        convnext_mlp.wgmma_launches += 1
    elif kernel_route == "wide":
        # t and h are scratch, from the caching allocator
        bf = dict(dtype=torch.bfloat16, device=x.device)
        t, h = torch.empty(M, C, **bf), torch.empty(M, 4 * C, **bf)
        _wide(ptrs, out, t, h, None, None, M, C, approximate, WIDE_ALL,
              x.dtype)
        convnext_mlp.wide_launches += 1
    else:
        err = _build.lib().vcd_convnext_mlp(
            *ptrs, out.data_ptr(), M, C, int(bool(approximate)),
            _DTYPE_CODE[x.dtype], stream)
        _build.check(err, "vcd_convnext_mlp")
    convnext_mlp.launches += 1
    return out


def _launch_train(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma, approximate):
    """The train kernel on CUDA tensors: (out, t, h_pre, m)."""
    ptrs, _keep, M, C = _kernel_operands(x, y, ln_w, ln_b, w1, b1, w2, b2,
                                         gamma)
    out = torch.empty_like(x)
    bf = dict(dtype=torch.bfloat16, device=x.device)
    t, m = torch.empty(M, C, **bf), torch.empty(M, C, **bf)
    h_pre = torch.empty(M, 4 * C, **bf)
    saved = (out.data_ptr(), t.data_ptr(), h_pre.data_ptr(), m.data_ptr())
    stream = _build.stream_ptr(x.device)
    kernel_route = route(x.dtype, C)
    if kernel_route == "wgmma":
        err = _build.lib().vcd_convnext_mlp_wgmma(
            *ptrs, *saved, M, C, int(bool(approximate)),
            _DTYPE_CODE[x.dtype], stream)
        _build.check(err, "vcd_convnext_mlp_wgmma")
        convnext_mlp_train.wgmma_launches += 1
    elif kernel_route == "wide":
        # h is scratch; t is the saved t
        h = torch.empty(M, 4 * C, **bf)
        _wide(ptrs, out, t, h, h_pre, m, M, C, approximate, WIDE_ALL,
              x.dtype)
        convnext_mlp_train.wide_launches += 1
    else:
        err = _build.lib().vcd_convnext_mlp_train(
            *ptrs, *saved, M, C, int(bool(approximate)),
            _DTYPE_CODE[x.dtype], stream)
        _build.check(err, "vcd_convnext_mlp_train")
    convnext_mlp_train.launches += 1
    return out, t, h_pre, m


def _wide(ptrs, out, t, h, h_pre, m, M, C, approximate, stages,
          dtype=torch.bfloat16):
    """One call of ``vcd_convnext_mlp_wide``: ``ptrs`` are x, y, ln_w, ln_b,
    W1, b1, W2, b2, γ (0 for what ``stages`` does not read); out, t, h,
    h_pre and m are the caller's fresh tensors or None; ``dtype`` is x's,
    y's and out's (t, h, h_pre and m are bf16)."""
    def ptr(a):
        return None if a is None else a.data_ptr()

    err = _build.lib().vcd_convnext_mlp_wide(
        *ptrs, ptr(out), ptr(t), ptr(h), ptr(h_pre), ptr(m), M, C,
        int(bool(approximate)), _DTYPE_CODE[dtype], stages,
        _build.stream_ptr((t if h is None else h).device))
    _build.check(err, "vcd_convnext_mlp_wide")


def _stage_operands(*named):
    """(name, tensor, dtype, align) → the tensors cast to the kernel's types
    and checked, for a wide stage alone (activations 16-byte aligned)."""
    cast = []
    for name, a, dtype, align in named:
        a = a.to(dtype).contiguous()
        _build.require_cuda(a, name, align=align)
        cast.append(a)
    return cast


def _activation_dtype(a: torch.Tensor) -> torch.dtype:
    """The dtype a wide stage reads an activation in: float32 as it is,
    anything else as bf16."""
    return torch.float32 if a.dtype == torch.float32 else torch.bfloat16


def ln_stage(y, ln_w, ln_b):
    """The wide kernel's LayerNorm stage alone: t [M, C] bf16 from y in
    bf16 or float32. A CPU tensor takes ``ln_stage_plain``."""
    if y.device.type == "cpu":
        return ln_stage_plain(y, ln_w, ln_b)
    C = y.shape[-1]
    dtype = _activation_dtype(y)
    y, ln_w, ln_b = _stage_operands(("y", y, dtype, 16),
                                    ("ln_w", ln_w, torch.float32, 1),
                                    ("ln_b", ln_b, torch.float32, 1))
    M = y.numel() // C
    t = torch.empty(M, C, dtype=torch.bfloat16, device=y.device)
    _wide([0, y.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr()] + [0] * 5,
          None, t, None, None, None, M, C, False, WIDE_LN, dtype)
    return t


def up_stage(t, w1, b1, approximate: bool):
    """The wide kernel's first product alone: (h_pre, h) [M, 4C] bf16 from
    t [M, C] bf16 and W1 [C, 4C] (read as nn.Linear's storage). A CPU
    tensor takes ``up_stage_plain``."""
    if t.device.type == "cpu":
        return up_stage_plain(t, w1, b1, approximate)
    M, C = t.shape
    t, w1t, b1 = _stage_operands(("t", t, torch.bfloat16, 16),
                                 ("w1", w1.t(), torch.bfloat16, 16),
                                 ("b1", b1, torch.float32, 1))
    h_pre, h = (torch.empty(M, 4 * C, dtype=torch.bfloat16, device=t.device)
                for _ in range(2))
    _wide([0, 0, 0, 0, w1t.data_ptr(), b1.data_ptr(), 0, 0, 0], None, t, h,
          h_pre, None, M, C, approximate, WIDE_UP)
    return h_pre, h


def down_stage(h, x, w2, b2, gamma):
    """The wide kernel's second product alone: (out [..., C] in the
    residual's dtype, m [M, C] bf16) from h [M, 4C] bf16, the residual x
    (float32 as it is, else bf16) and W2 [4C, C] (read as nn.Linear's
    storage). A CPU tensor takes ``down_stage_plain``, its m rounded to
    bf16 as the kernel saves it."""
    if h.device.type == "cpu":
        out, m = down_stage_plain(h, x, w2, b2, gamma)
        return out, m.to(torch.bfloat16)
    C = x.shape[-1]
    M = h.shape[0]
    dtype = _activation_dtype(x)
    h, xc, w2t, b2, gamma = _stage_operands(
        ("h", h, torch.bfloat16, 16), ("x", x, dtype, 16),
        ("w2", w2.t(), torch.bfloat16, 16), ("b2", b2, torch.float32, 1),
        ("gamma", gamma, torch.float32, 1))
    out = torch.empty_like(xc)
    m = torch.empty(M, C, dtype=torch.bfloat16, device=h.device)
    _wide([xc.data_ptr(), 0, 0, 0, 0, 0, w2t.data_ptr(), b2.data_ptr(),
           gamma.data_ptr()], out, None, h, None, m, M, C, False, WIDE_DOWN,
          dtype)
    return out, m


def convnext_mlp_train(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma,
                       approximate: bool):
    """K3's train variant: (out [..., C], t [M, C], h_pre [M, 4C],
    m [M, C]), the last three bf16. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return convnext_mlp_train_plain(x, y, ln_w, ln_b, w1, b1, w2, b2,
                                        gamma, approximate)
    return _launch_train(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma, approximate)


convnext_mlp_train.launches = 0
# the launches among them that took the Hopper kernel and the split wgmma
# kernel (``route``)
convnext_mlp_train.wgmma_launches = 0
convnext_mlp_train.wide_launches = 0


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 operands with a float32 result, as the JAX package's
    ``jnp.dot(..., preferred_element_type=jnp.float32)``."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


@functools.lru_cache(maxsize=None)
def _gelu_tables(device: torch.device, approximate: bool):
    """``gelu_f32`` rounded to bf16 and ``gelu_grad_f32`` at every bf16
    value, indexed by its 16 bits. h_pre is bf16, so the backward looks
    GELU(h_pre) and GELU′(h_pre) up, one gather each, instead of a dozen
    float32 passes over the [M, 4C] activation; the values are the same."""
    v = torch.arange(65536, dtype=torch.int32, device=device).to(
        torch.int16).view(torch.bfloat16).float()
    return (gelu_f32(v, approximate).to(torch.bfloat16),
            gelu_grad_f32(v, approximate))


def convnext_mlp_bwd(g, y, t, h_pre, m, ln_w, w1, w2, gamma, approximate):
    """The JAX ``_bwd`` in torch ops: the gradients of x, y, ln_w, ln_b, w1,
    b1, w2, b2 and γ from the incoming gradient g and the train variant's
    saved y, t, h_pre and m."""
    C = y.shape[-1]
    g2 = g.reshape(-1, C).to(torch.bfloat16)
    dgamma = (g2.float() * m.float()).sum(0).to(gamma.dtype)
    v = g2 * gamma.to(torch.bfloat16)  # the gradient into pwconv2's output
    gelu_tab, gelu_grad_tab = _gelu_tables(h_pre.device, bool(approximate))
    # h_pre's bits as table indices (a negative int16 wraps to its uint16)
    idx = h_pre.view(torch.int16).int()
    h = gelu_tab[idx]
    dw2 = _mm_f32(h.t(), v).to(w2.dtype)
    db2 = v.float().sum(0)
    dh = _mm_f32(v, w2.to(torch.bfloat16).t())
    dh_pre = gelu_grad_tab[idx].mul_(dh)
    dh_pre_b = dh_pre.to(torch.bfloat16)
    dw1 = _mm_f32(t.t(), dh_pre_b).to(w1.dtype)
    db1 = dh_pre.sum(0)
    dt = _mm_f32(dh_pre_b, w1.to(torch.bfloat16).t())

    # LayerNorm backward, statistics recomputed in float32 from y (one
    # fused pass where the JAX package writes it out term by term; the
    # same float32 math in another order)
    yf = y.reshape(-1, C).to(torch.float32)
    mu, rstd = _ln_stats(yf)
    lw = ln_w.float()
    dy, dscale, dbias = torch.ops.aten.native_layer_norm_backward(
        dt, yf, [C], mu, rstd, lw, torch.zeros_like(lw), [True, True, True])
    return (g, dy.to(y.dtype).reshape(y.shape), dscale.to(ln_w.dtype),
            dbias.to(ln_w.dtype), dw1, db1.to(w1.dtype), dw2,
            db2.to(w2.dtype), dgamma)


class _ConvNeXtMLP(torch.autograd.Function):
    """K3 with the JAX package's ``custom_vjp``: the train variant forward,
    ``convnext_mlp_bwd`` backward."""

    @staticmethod
    def forward(ctx, x, y, ln_w, ln_b, w1, b1, w2, b2, gamma, approximate):
        out, t, h_pre, m = convnext_mlp_train(x, y, ln_w, ln_b, w1, b1, w2,
                                              b2, gamma, approximate)
        ctx.save_for_backward(y, t, h_pre, m, ln_w, w1, w2, gamma)
        ctx.approximate = approximate
        return out

    @staticmethod
    def backward(ctx, g):
        y, t, h_pre, m, ln_w, w1, w2, gamma = ctx.saved_tensors
        return (*convnext_mlp_bwd(g, y, t, h_pre, m, ln_w, w1, w2, gamma,
                                  ctx.approximate), None)


def convnext_mlp(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma,
                 approximate: bool) -> torch.Tensor:
    """K3. x (shortcut) and y (dwconv output): [..., C]. Parameters may be
    float32; the kernel path casts them to its types (W1, W2 to bf16, the
    rest to float32). Returns [..., C] in x's dtype.

    Where a gradient is needed, the call goes through ``_ConvNeXtMLP``: the
    train variant, then the torch backward. Otherwise a CPU tensor takes
    the plain version and a CUDA tensor launches the eval kernel, through
    the op ``vcd::convnext_mlp`` (``ops/library.py``), whose implementation
    is ``_eval``, so that ``torch.export`` can trace it."""
    args = (x, y, ln_w, ln_b, w1, b1, w2, b2, gamma)
    _check(*args)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _ConvNeXtMLP.apply(*args, approximate)
    from vision_collision_detection_tpu_torch.ops import library

    return library.convnext_mlp(*args, bool(approximate))


def _eval(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma, approximate):
    """K3's eval variant on real tensors: the plain version on the CPU, the
    kernel on the card."""
    args = (x, y, ln_w, ln_b, w1, b1, w2, b2, gamma)
    if x.device.type == "cpu":
        return convnext_mlp_plain(*args, approximate)
    return _launch_eval(*args, approximate)


convnext_mlp.launches = 0
# the launches among them that took the Hopper kernel and the split wgmma
# kernel (``route``)
convnext_mlp.wgmma_launches = 0
convnext_mlp.wide_launches = 0
