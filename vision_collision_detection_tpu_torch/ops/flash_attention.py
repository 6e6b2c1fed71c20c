"""K4: flash self-attention for the ViViT spatial blocks, with its gradient.

Replaces the TPU kernels that
``vision_collision_detection_tpu/ops/flash_attention.py`` ``flash_mha``
reaches in the JAX library (``jax/experimental/pallas/ops/tpu/
flash_attention.py``): the forward ``_flash_attention_impl``, the backward
``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq``, tied by a
``jax.custom_vjp`` there and by the ``torch.autograd.Function``
``_FlashMHA`` here. Three CUDA kernels and a helper:

- forward: ``o = softmax(q·kᵀ·scale)·v`` per (batch, head) with an online
  softmax, and one float32 log-sum-exp per row (the TPU kernel's l and m in
  one number) where a gradient is needed. 4·S²·D flops per (batch, head)
  against 8·S·D bytes (bf16), S/2 flops per byte: at S = 576 that is 288, a
  hair under the H100's ridge of 295, so the bound is bytes there and
  operations from S = 592 on. For bf16 with head_dim 64 it is built for
  Hopper (``ops/csrc/flash_attention_fwd_wgmma.cu``: a persistent block of
  three consumer warpgroups, 192 queries, K and V tiles streamed by TMA,
  two key tiles a step so that one tile's softmax runs under the other's
  products); head_dim 16 and float32 keep the ``mma.sync`` and CUDA-core
  kernels of ``ops/csrc/flash_attention.cu``. ``fwd_route`` is the rule.
- backward dK/dV and backward dQ: each recomputes p from q, k and the saved
  log-sum-exp; no float atomics, so two runs agree bit for bit. Bound:
  operations, 8·S²·D flops per (batch, head) for dK/dV and 6·S²·D for dQ
  (the logits and do·vᵀ in each), against 12·S·D and 10·S·D bytes. For bf16
  with head_dim 64, the scaled ViViT configuration's case, they are built
  for Hopper (``ops/csrc/flash_attention_bwd_wgmma.cu``): warpgroup products
  (``wgmma``) on 128-byte-swizzled tiles that TMA writes from one tensor map
  per operand, a producer warp and ``mbarrier``s around a ring of tiles,
  blocks of 128 keys (dK/dV) or 192 queries (dQ). head_dim 16 and float32
  keep the ``mma.sync`` and CUDA-core kernels of
  ``ops/csrc/flash_attention_bwd.cu``; the choice is by dtype and head_dim
  in the C launcher.
- ``di = Σ(o ⊙ do)``, the row term of ds, by the row kernel
  ``vcd_flash_bwd_di`` (``ops/csrc/flash_attention_bwd.cu``; bound: bytes, o
  and do read once). In the library it is ``jnp`` outside the Pallas
  kernels, so it is a helper of this backward, not a TPU kernel of its own;
  ``_row_dot`` is its plain version.

Numerics, shared by the kernels and the plain versions: logits, softmax and
every accumulation in float32; p (and, in the backward, ds) rounded to the
inputs' dtype before its product with v (do, q, k).

q, k, v come as ``[B, S, H, D]``, the projections' own layout, and are read
through their strides: the TPU wrapper's ``swapaxes`` and its zero-padding
of S to a multiple of 128 are TPU block constraints and have no counterpart
here. Keys past S are masked by length inside the kernels, for any S ≥ 1.

**Dispatch.** A CPU tensor takes the plain version; a CUDA tensor launches
the kernels or raises (head_dim other than 16 or 64, a dtype other than
bf16 or float32), at every sequence length. The JAX package's gate
``flash_supported`` (S ≥ 128 and a TPU backend) is the TPU kernel's block
constraint and its CPU tests' way out; the port has neither reason, so
``FlashSelfAttention`` always calls ``flash_mha``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn as nn

from vision_collision_detection_tpu_torch.ops import _build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
KERNEL_HEAD_DIMS = (16, 64)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"expected q [B, S, H, D], got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be one shape")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] → float32 [B, H, S, D]."""
    return t.to(torch.float32).permute(0, 2, 1, 3)


def _flash_fwd_plain(q, k, v, sm_scale: float, need_lse: bool = True):
    """(o [B, S, H, D] in q's dtype, lse float32 [B, H, S]); the signature
    of ``_launch_fwd``, whose plain twin it is."""
    s = torch.matmul(_heads_first(q), _heads_first(k).transpose(-1, -2))
    s = s * sm_scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(q.dtype)
    o = torch.matmul(p.to(torch.float32), _heads_first(v))
    return _tokens_first(o, q.dtype), lse


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version of K4's forward, with its roundings: float32
    logits and softmax, p rounded to the inputs' dtype, then p·v in
    float32, rounded to the inputs' dtype. Differentiable by autograd."""
    _check(q, k, v)
    return _flash_fwd_plain(q, k, v, sm_scale)[0]


def _row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = Σ_d o·do in float32, [B, H, S]."""
    return (o.to(torch.float32) * do.to(torch.float32)).sum(-1).permute(
        0, 2, 1).contiguous()


def _bwd_p_ds(q, k, v, do, lse, di, sm_scale: float):
    """What both backward kernels recompute, float32 [B, H, S, S]: p from
    the saved log-sum-exp and ds = p ⊙ (do·vᵀ − di)·scale, each rounded to
    q's dtype as it enters its product."""
    qf, kf, vf, dof = (_heads_first(t) for t in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - di[..., None]) * sm_scale).to(q.dtype).float()
    return p.to(q.dtype).float(), ds


def _tokens_first(t: torch.Tensor, dtype) -> torch.Tensor:
    """float32 [B, H, S, D] → contiguous [B, S, H, D] in ``dtype``."""
    return t.permute(0, 2, 1, 3).to(dtype).contiguous()


def flash_mha_bwd_dkv_plain(q, k, v, do, lse, di, sm_scale: float):
    """Plain PyTorch version of K4's dK/dV kernel, written out after the
    library's ``mha_reference_bwd`` with the kernel's roundings: (dk, dv),
    each [B, S, H, D] in q's dtype. ``lse`` is the forward's log-sum-exp and
    ``di`` = Σ_d o·do, both float32 [B, H, S]."""
    p, ds = _bwd_p_ds(q, k, v, do, lse, di, sm_scale)
    dv = torch.matmul(p.transpose(-1, -2), _heads_first(do))
    dk = torch.matmul(ds.transpose(-1, -2), _heads_first(q))
    return _tokens_first(dk, q.dtype), _tokens_first(dv, q.dtype)


def flash_mha_bwd_dq_plain(q, k, v, do, lse, di, sm_scale: float):
    """Plain PyTorch version of K4's dQ kernel: dq [B, S, H, D] in q's
    dtype, from the same p and ds as ``flash_mha_bwd_dkv_plain``."""
    _, ds = _bwd_p_ds(q, k, v, do, lse, di, sm_scale)
    return _tokens_first(torch.matmul(ds, _heads_first(k)), q.dtype)


def _kernel_view(t: torch.Tensor, name: str,
                 vectors: bool = False) -> torch.Tensor:
    """``t`` as the kernels read it: a CUDA tensor whose last axis is
    contiguous and, for bf16 (``vectors``: for any dtype), whose rows start
    on 16-byte boundaries. A view that is not (a transposed gradient, an
    odd offset) is copied, and the copy is counted in ``flash_mha.copies``."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    align = (16 // t.element_size()
             if vectors or t.dtype == torch.bfloat16 else 1)
    ok = (t.stride(-1) == 1 and t.data_ptr() % (align * t.element_size()) == 0
          and all(s % align == 0 for s in t.stride()[:-1]))
    if not ok:
        flash_mha.copies += 1
        t = t.contiguous()
    return t


def _strides(*tensors) -> ctypes.Array:
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(flat))(*flat)


def _kernel_dims(q: torch.Tensor):
    B, S, H, D = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_mha kernels take bf16 or float32, got "
                         f"{q.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_mha kernels take head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if B > 65535 or H > 65535 or min(B, S, H) < 1:
        raise ValueError(f"flash_mha kernels take 1 ≤ B, H ≤ 65535 and "
                         f"S ≥ 1, got {tuple(q.shape)}")
    return B, S, H, D


def fwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which forward kernel a CUDA call takes: ``"wgmma"`` (the Hopper
    kernel) for bf16 with head_dim 64, ``"mma"`` (``flash_attention.cu``)
    for the other dtypes and head_dims the kernels take."""
    return ("wgmma" if dtype == torch.bfloat16 and head_dim == 64
            else "mma")


def _launch_fwd(q, k, v, sm_scale: float, need_lse: bool):
    """The forward kernel on CUDA tensors: (o, lse or None)."""
    B, S, H, D = _kernel_dims(q)
    q, k, v = (_kernel_view(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v")))
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if need_lse else None)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if need_lse else None, _strides(q, k, v))
    stream = _build.stream_ptr(q.device)
    if fwd_route(q.dtype, D) == "wgmma":
        err = _build.lib().vcd_flash_fwd_wgmma(*ptrs, B, S, H,
                                               float(sm_scale), stream)
        _build.check(err, "vcd_flash_fwd_wgmma")
        flash_mha.wgmma_launches += 1
    else:
        err = _build.lib().vcd_flash_fwd(*ptrs, B, S, H, D, float(sm_scale),
                                         _DTYPE_CODE[q.dtype], stream)
        _build.check(err, "vcd_flash_fwd")
    flash_mha.launches += 1
    return o, lse


def _bwd_operands(q, k, v, do, lse, di):
    B, S, H, D = _kernel_dims(q)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must be {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for t, name in ((lse, "lse"), (di, "di")):
        if tuple(t.shape) != (B, H, S) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {(B, H, S)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        _build.require_cuda(t, name)
    views = [_kernel_view(t, n)
             for t, n in ((q, "q"), (k, "k"), (v, "v"), (do, "do"))]
    return views, (B, S, H, D)


def _launch_bwd_dkv(q, k, v, do, lse, di, sm_scale: float):
    """The dK/dV kernel on CUDA tensors: (dk, dv)."""
    views, (B, S, H, D) = _bwd_operands(q, k, v, do, lse, di)
    dk = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    err = _build.lib().vcd_flash_bwd_dkv(
        *[t.data_ptr() for t in views], lse.data_ptr(), di.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _strides(*views), B, S, H, D,
        float(sm_scale), _DTYPE_CODE[q.dtype], _build.stream_ptr(q.device))
    _build.check(err, "vcd_flash_bwd_dkv")
    flash_mha_bwd_dkv.launches += 1
    return dk, dv


def _launch_bwd_dq(q, k, v, do, lse, di, sm_scale: float):
    """The dQ kernel on CUDA tensors: dq."""
    views, (B, S, H, D) = _bwd_operands(q, k, v, do, lse, di)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    err = _build.lib().vcd_flash_bwd_dq(
        *[t.data_ptr() for t in views], lse.data_ptr(), di.data_ptr(),
        dq.data_ptr(), _strides(*views), B, S, H, D, float(sm_scale),
        _DTYPE_CODE[q.dtype], _build.stream_ptr(q.device))
    _build.check(err, "vcd_flash_bwd_dq")
    flash_mha_bwd_dq.launches += 1
    return dq


def _launch_bwd_di(o, do):
    """The row kernel on CUDA tensors: di float32 [B, H, S]."""
    B, S, H, D = _kernel_dims(o)
    if do.shape != o.shape or do.dtype != o.dtype:
        raise ValueError(f"do must be {tuple(o.shape)} {o.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    o, do = (_kernel_view(t, n, vectors=True) for t, n in ((o, "o"),
                                                           (do, "do")))
    di = torch.empty((B, H, S), dtype=torch.float32, device=o.device)
    err = _build.lib().vcd_flash_bwd_di(
        o.data_ptr(), do.data_ptr(), di.data_ptr(), _strides(o, do), B, S, H,
        D, _DTYPE_CODE[o.dtype], _build.stream_ptr(o.device))
    _build.check(err, "vcd_flash_bwd_di")
    flash_mha_bwd_di.launches += 1
    return di


def flash_mha_bwd_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = Σ_d o·do in float32, [B, H, S], for o and do [B, S, H, D]: the
    row term of ds in both backward kernels. A CPU tensor takes the plain
    version ``_row_dot``; a CUDA tensor launches the row kernel."""
    if o.device.type == "cpu":
        return _row_dot(o, do)
    return _launch_bwd_di(o, do)


flash_mha_bwd_di.launches = 0


def flash_mha_bwd_dkv(q, k, v, do, lse, di, sm_scale: float):
    """K4's dK/dV backward: (dk, dv). A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel."""
    if q.device.type == "cpu":
        return flash_mha_bwd_dkv_plain(q, k, v, do, lse, di, sm_scale)
    return _launch_bwd_dkv(q, k, v, do, lse, di, sm_scale)


flash_mha_bwd_dkv.launches = 0


def flash_mha_bwd_dq(q, k, v, do, lse, di, sm_scale: float):
    """K4's dQ backward. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    if q.device.type == "cpu":
        return flash_mha_bwd_dq_plain(q, k, v, do, lse, di, sm_scale)
    return _launch_bwd_dq(q, k, v, do, lse, di, sm_scale)


flash_mha_bwd_dq.launches = 0


def flash_mha_fwd(q, k, v, sm_scale: float):
    """K4's forward with its log-sum-exp: (o [B, S, H, D], lse float32
    [B, H, S]). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, sm_scale)
    return _launch_fwd(q, k, v, sm_scale, need_lse=True)


class _FlashMHA(torch.autograd.Function):
    """K4 with the JAX library's ``custom_vjp``: the forward saves q, k, v,
    o and the log-sum-exp; the backward runs the row kernel for di, then the
    dK/dV and the dQ kernel."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = flash_mha_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        args = (q, k, v, do, lse, flash_mha_bwd_di(o, do), ctx.sm_scale)
        dk, dv = flash_mha_bwd_dkv(*args)
        return flash_mha_bwd_dq(*args), dk, dv, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float) -> torch.Tensor:
    """K4. q, k, v: [B, S, H, D] (views are read through their strides);
    returns a contiguous [B, S, H, D] in their dtype.

    Where a gradient is needed, the call goes through ``_FlashMHA``.
    Otherwise a CPU tensor takes the plain version and a CUDA tensor
    launches the forward kernel, through the op ``vcd::flash_mha``
    (``ops/library.py``), whose implementation is ``_forward``, so that
    ``torch.export`` can trace it."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashMHA.apply(q, k, v, sm_scale)
    from vision_collision_detection_tpu_torch.ops import library

    return library.flash_mha(q, k, v, float(sm_scale))


def _forward(q, k, v, sm_scale: float) -> torch.Tensor:
    """K4's forward without its log-sum-exp on real tensors: the plain
    version on the CPU, the kernel on the card."""
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, sm_scale)
    return _launch_fwd(q, k, v, sm_scale, need_lse=False)[0]


flash_mha.launches = 0
# the launches among them that took the Hopper kernel (``fwd_route``)
flash_mha.wgmma_launches = 0
flash_mha.copies = 0


class FlashSelfAttention(nn.Module):
    """Self-attention with the parameters of flax's
    ``MultiHeadDotProductAttention`` (query, key, value and out
    projections), the attention itself computed by ``flash_mha``. The
    projections run in ``dtype``, as the flax ``DenseGeneral``s do.

    Under tensor parallelism (``parallel/tp.py``) the query, key and value
    projections hold this rank's heads (their output rows), the out
    projection the matching input columns, and ``tp`` the model group's
    collectives: ``tp.enter`` before the projections (its backward sums
    the input's gradient over the group), ``tp.exit`` after the out
    projection (its forward sums the partial products), whose bias is then
    added once."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.bfloat16):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by heads {num_heads}")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.dtype = dtype
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.tp = None

    def heads(self, x: torch.Tensor):
        """x [B, S, dim] → q, k, v, each [B, S, H, D] in ``dtype``; H is
        this rank's heads under tensor parallelism."""
        B, S, _ = x.shape
        x = x.to(self.dtype)
        if self.tp is not None:
            x = self.tp.enter(x)
        local_heads = self.query.weight.shape[0] // self.head_dim
        return tuple(
            nn.functional.linear(x, m.weight.to(self.dtype),
                                 m.bias.to(self.dtype)).view(
                                     B, S, local_heads, self.head_dim)
            for m in (self.query, self.key, self.value))

    def project_out(self, o: torch.Tensor) -> torch.Tensor:
        """o [B, S, H, D] → [B, S, dim] through the out projection."""
        B, S = o.shape[:2]
        o = o.reshape(B, S, -1)
        w, b = self.out.weight.to(self.dtype), self.out.bias.to(self.dtype)
        if self.tp is None:
            return nn.functional.linear(o, w, b)
        return self.tp.exit(nn.functional.linear(o, w)) + b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.heads(x)
        return self.project_out(flash_mha(q, k, v, self.head_dim ** -0.5))
