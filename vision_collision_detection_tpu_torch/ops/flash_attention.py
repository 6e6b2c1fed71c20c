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
  products), and for float32 with head_dim 64 too
  (``ops/csrc/flash_attention_fwd_f32.cu``: the same design on split
  products, below). head_dim 16 (vivit_tiny) has Hopper kernels of its
  own in the same files, bf16 and float32 (``ops/csrc/flash_d16.cuh``:
  32-byte-swizzled tiles, four consumer warpgroups and items of 256
  queries, keys in tiles of 64; there the softmax's exponentials, not the
  bytes or the products, set the floor). The ``mma.sync`` (bf16) and
  CUDA-core (float32) kernels of ``ops/csrc/flash_attention.cu`` take no
  route: they stay compiled as the card's yardstick. ``route`` is the
  rule, for the backward too.
- backward dK/dV and backward dQ: each recomputes p from q, k and the saved
  log-sum-exp; no float atomics, so two runs agree bit for bit. Bound:
  operations, 8·S²·D flops per (batch, head) for dK/dV and 6·S²·D for dQ
  (the logits and do·vᵀ in each), against 12·S·D and 10·S·D bytes. For bf16
  with head_dim 64, the scaled ViViT configuration's case, they are built
  for Hopper (``ops/csrc/flash_attention_bwd_wgmma.cu``): warpgroup products
  (``wgmma``) on 128-byte-swizzled tiles that TMA writes from one tensor map
  per operand, a producer warp and ``mbarrier``s around a ring of tiles,
  blocks of 128 keys (dK/dV) or 192 queries (dQ); float32 with head_dim
  64 on the same design with split products
  (``ops/csrc/flash_attention_bwd_f32.cu``); head_dim 16 on the designs
  of ``ops/csrc/flash_d16.cuh`` in the same two files. The ``mma.sync``
  and CUDA-core kernels of ``ops/csrc/flash_attention_bwd.cu`` are the
  yardstick. Each route has its own C entries, so no C launcher chooses.
- ``di = Σ(o ⊙ do)``, the row term of ds, by the row kernel
  ``vcd_flash_bwd_di`` (``ops/csrc/flash_attention_bwd.cu``; bound: bytes, o
  and do read once). In the library it is ``jnp`` outside the Pallas
  kernels, so it is a helper of this backward, not a TPU kernel of its own;
  ``_row_dot`` is its plain version.

Numerics, shared by the kernels and the plain versions: logits, softmax and
every accumulation in float32; p (and, in the backward, ds) rounded to the
inputs' dtype before its product with v (do, q, k).

**float32 on the tensor cores.** The float32 kernels (head_dim 64 and 16)
take each float32 operand x as hi + lo, hi = bf16(x) and lo = bf16(x − hi),
and each product a·b as lo_a·hi_b + hi_a·lo_b + hi_a·hi_b: three bf16 products
into a float32 accumulator (989 TFLOP/s where scalar float32 has 67), each
within about 3·2^-18 of a·b. q, k, v and do are split by a pass that writes
hi and lo bf16 copies into scratch the wrapper allocates
(``flash_mha_split``, one launch for every operand): once a forward, and
once a backward, whose dK/dV and dQ kernels read the same copies. p and ds
are split in registers. One bf16 or one TF32
product alone (2^-9, 2^-11) would miss the float32 rule of 2^-14 of the
largest value that ``chip_smoke.py`` holds them to. v and do are split in
three, and p·v and do·vᵀ keep every term down to 2^-18 (five and six
products): ds subtracts di = Σ o·do from do·vᵀ, and where the softmax
weighs one key the two nearly cancel (``ops/csrc/flash_f32.cuh``).

q, k, v come as ``[B, S, H, D]``, the projections' own layout, and are read
through their strides: the TPU wrapper's ``swapaxes`` and its zero-padding
of S to a multiple of 128 are TPU block constraints and have no counterpart
here. Keys past S are masked by length inside the kernels, for any S ≥ 1.

**Dispatch.** A CPU tensor takes the plain version; a CUDA tensor launches
the kernels of its route or raises (head_dim other than 16 or 64, a dtype
other than bf16 or float32), at every sequence length. The JAX package's
gate ``flash_supported`` (S ≥ 128 and a TPU backend) is the TPU kernel's
block constraint and its CPU tests' way out; the port has neither reason,
so ``FlashSelfAttention`` always calls ``flash_mha``.
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


def _flash_fwd_plain(q, k, v, sm_scale: float, need_lse: bool = True,
                     split=None):
    """(o [B, S, H, D] in q's dtype, lse float32 [B, H, S]); the signature
    of ``_launch_fwd``, whose plain twin it is (``split``, the float32
    kernels' copies of q, k, v, is not read)."""
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


def flash_mha_bwd_dkv_plain(q, k, v, do, lse, di, sm_scale: float,
                            split=None):
    """Plain PyTorch version of K4's dK/dV kernel, written out after the
    library's ``mha_reference_bwd`` with the kernel's roundings: (dk, dv),
    each [B, S, H, D] in q's dtype. ``lse`` is the forward's log-sum-exp and
    ``di`` = Σ_d o·do, both float32 [B, H, S]. ``split`` (the float32
    kernels' copies of q, k, v, do) is not read: it is there so that the
    plain version takes its launcher's arguments."""
    p, ds = _bwd_p_ds(q, k, v, do, lse, di, sm_scale)
    dv = torch.matmul(p.transpose(-1, -2), _heads_first(do))
    dk = torch.matmul(ds.transpose(-1, -2), _heads_first(q))
    return _tokens_first(dk, q.dtype), _tokens_first(dv, q.dtype)


def flash_mha_bwd_dq_plain(q, k, v, do, lse, di, sm_scale: float,
                           split=None):
    """Plain PyTorch version of K4's dQ kernel: dq [B, S, H, D] in q's
    dtype, from the same p and ds as ``flash_mha_bwd_dkv_plain`` (which
    says why it takes ``split``)."""
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


def route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernels a CUDA call takes, forward and backward alike, all of
    them Hopper designs: ``"wgmma"`` (``flash_attention_fwd_wgmma.cu``,
    ``flash_attention_bwd_wgmma.cu``) for bf16 with head_dim 64,
    ``"f32_wgmma"`` (``flash_attention_fwd_f32.cu``,
    ``flash_attention_bwd_f32.cu``: split products) for float32 with
    head_dim 64, ``"wgmma_d16"`` and ``"f32_wgmma_d16"`` (the same files'
    head_dim-16 entries, ``flash_d16.cuh``) for bf16 and float32 with
    head_dim 16. ``"mma"`` (``flash_attention.cu``,
    ``flash_attention_bwd.cu``: mma.sync for bf16, CUDA cores for float32)
    is no route of this rule: only a caller that forces it (the card's
    yardstick) reaches those kernels."""
    f32 = dtype != torch.bfloat16
    if head_dim == 64:
        return "f32_wgmma" if f32 else "wgmma"
    if head_dim == 16:
        return "f32_wgmma_d16" if f32 else "wgmma_d16"
    raise ValueError(f"flash_mha kernels take head_dim in "
                     f"{KERNEL_HEAD_DIMS}, got {head_dim}")


# each route's C entry suffix and the wrapper's counter of its launches
_ROUTES = {"wgmma": ("_wgmma", "wgmma_launches"),
           "f32_wgmma": ("_f32", "f32_launches"),
           "wgmma_d16": ("_wgmma_d16", "d16_launches"),
           "f32_wgmma_d16": ("_f32_d16", "d16_f32_launches"),
           "mma": ("", None)}
# the routes whose kernels read split copies
_SPLIT_ROUTES = ("f32_wgmma", "f32_wgmma_d16")


def _count(fn, kernels: str) -> None:
    """One launch of ``fn``'s kernel on route ``kernels``."""
    fn.launches += 1
    counter = _ROUTES[kernels][1]
    if counter:
        setattr(fn, counter, getattr(fn, counter) + 1)


# parts of each operand in the split copies: q and k in two (hi, lo), v and
# do in three (hi, lo, lo2)
_SPLIT_PARTS = (2, 2, 3, 3)
_SPLIT_NAMES = ("q", "k", "v", "do")


def flash_mha_split_plain(q, k, v, do=None) -> torch.Tensor:
    """Plain version of the float32 kernels' split pass: bf16
    [7, B, S, H, D] (q hi, lo; k hi, lo; v hi, lo, lo2) or, with do,
    [10, B, S, H, D] (do's hi, lo, lo2 after): hi = bf16(x),
    lo = bf16(x − hi), lo2 = bf16(x − hi − lo), each difference exact in
    float32."""
    parts = []
    for t, n in zip((q, k, v, do), _SPLIT_PARTS):
        if t is None:
            break
        rest = t.to(torch.float32)
        for _ in range(n):
            part = rest.to(torch.bfloat16)
            parts.append(part)
            rest = rest - part.to(torch.float32)
    return torch.stack(parts)


def _launch_split(q, k, v, do=None) -> torch.Tensor:
    """The split pass on CUDA tensors: one launch for every operand."""
    B, S, H, D = _kernel_dims(q)
    if q.dtype != torch.float32:
        raise ValueError(f"the split pass takes float32, got {q.dtype}")
    ops = [t for t in (q, k, v, do) if t is not None]
    if any(t.shape != q.shape or t.dtype != q.dtype for t in ops):
        raise ValueError(f"q, k, v, do must be one shape and dtype, got "
                         f"{[(tuple(t.shape), t.dtype) for t in ops]}")
    ops = [_kernel_view(t, n, vectors=True) for t, n in zip(ops, _SPLIT_NAMES)]
    split = torch.empty((sum(_SPLIT_PARTS[:len(ops)]), B, S, H, D),
                        dtype=torch.bfloat16, device=q.device)
    ptrs = [t.data_ptr() for t in ops] + [None] * (4 - len(ops))
    err = _build.lib().vcd_flash_split_f32(
        *ptrs, _strides(*ops), split.data_ptr(), B, S, H, D,
        _build.stream_ptr(q.device))
    _build.check(err, "vcd_flash_split_f32")
    flash_mha_split.launches += 1
    return split


def flash_mha_split(q, k, v, do=None) -> torch.Tensor:
    """The split copies that K4's float32 kernels read (``route``
    ``"f32_wgmma"`` and ``"f32_wgmma_d16"``): of q, k, v for the forward,
    of q, k, v, do for the backward, whose dK/dV and dQ kernels share them;
    the layout of
    ``flash_mha_split_plain``. A CPU tensor takes the plain version; a CUDA
    tensor launches the split pass."""
    if q.device.type == "cpu":
        return flash_mha_split_plain(q, k, v, do)
    return _launch_split(q, k, v, do)


flash_mha_split.launches = 0


def _split_of(split, *operands) -> torch.Tensor:
    """``split``, checked against the layout the float32 kernels read, or
    where it is None the split copies of ``operands`` (CUDA tensors), made
    here."""
    if split is None:
        return _launch_split(*operands)
    B, S, H, D = operands[0].shape
    want = (sum(_SPLIT_PARTS[:len(operands)]), B, S, H, D)
    if (tuple(split.shape) != want or split.dtype != torch.bfloat16
            or not split.is_contiguous()
            or split.device != operands[0].device):
        raise ValueError(f"split must be contiguous bf16 {want} on "
                         f"{operands[0].device}, got {split.dtype} "
                         f"{tuple(split.shape)} on {split.device}")
    return split


def _launch_fwd(q, k, v, sm_scale: float, need_lse: bool, split=None):
    """The forward kernel on CUDA tensors: (o, lse or None). ``split``: the
    float32 route's split copies of q, k, v (``flash_mha_split``), made
    here where not given."""
    B, S, H, D = _kernel_dims(q)
    kernels = route(q.dtype, D)
    name = "vcd_flash_fwd" + _ROUTES[kernels][0]
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if need_lse else None)
    lse_ptr = lse.data_ptr() if need_lse else None
    if kernels in _SPLIT_ROUTES:
        split = _split_of(split, q, k, v)
        args = (split.data_ptr(), o.data_ptr(), lse_ptr, B, S, H,
                float(sm_scale))
    else:
        q, k, v = (_kernel_view(t, n) for t, n in ((q, "q"), (k, "k"),
                                                    (v, "v")))
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse_ptr, _strides(q, k, v), B, S, H)
        args += ((float(sm_scale),) if kernels != "mma" else
                 (D, float(sm_scale), _DTYPE_CODE[q.dtype]))
    err = getattr(_build.lib(), name)(*args, _build.stream_ptr(q.device))
    _build.check(err, name)
    _count(flash_mha, kernels)
    return o, lse


def _bwd_dims(q, do, lse, di):
    """(B, S, H, D) of a backward call, its arguments checked."""
    B, S, H, D = _kernel_dims(q)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must be {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for t, name in ((lse, "lse"), (di, "di")):
        if tuple(t.shape) != (B, H, S) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {(B, H, S)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        _build.require_cuda(t, name)
    return B, S, H, D


def _launch_bwd(fn, name: str, operands, lse, di, outs, sm_scale: float,
                split) -> None:
    """One backward kernel on CUDA tensors, through the C entry of its
    route (``name`` + the route's suffix, ``_ROUTES``), counted on ``fn``.
    The float32 routes read ``split``, the split copies of q, k, v, do
    (made here where it is None); the others read the operands through
    their strides."""
    B, S, H, D = outs[0].shape
    kernels = route(operands[0].dtype, D)
    name += _ROUTES[kernels][0]
    tail = ([lse.data_ptr(), di.data_ptr()]
            + [t.data_ptr() for t in outs])
    if kernels in _SPLIT_ROUTES:
        split = _split_of(split, *operands)
        args = [split.data_ptr()] + tail + [B, S, H, float(sm_scale)]
        device = split.device
    else:
        views = [_kernel_view(t, n) for t, n in zip(operands, _SPLIT_NAMES)]
        args = ([t.data_ptr() for t in views] + tail + [_strides(*views)]
                + [B, S, H])
        args += ([float(sm_scale)] if kernels != "mma" else
                 [D, float(sm_scale), _DTYPE_CODE[views[0].dtype]])
        device = views[0].device
    err = getattr(_build.lib(), name)(*args, _build.stream_ptr(device))
    _build.check(err, name)
    _count(fn, kernels)


def _launch_bwd_dkv(q, k, v, do, lse, di, sm_scale: float, split=None):
    """The dK/dV kernel on CUDA tensors: (dk, dv)."""
    dims = _bwd_dims(q, do, lse, di)
    dk = torch.empty(dims, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _launch_bwd(flash_mha_bwd_dkv, "vcd_flash_bwd_dkv", (q, k, v, do), lse,
                di, (dk, dv), sm_scale, split)
    return dk, dv


def _launch_bwd_dq(q, k, v, do, lse, di, sm_scale: float, split=None):
    """The dQ kernel on CUDA tensors: dq."""
    dims = _bwd_dims(q, do, lse, di)
    dq = torch.empty(dims, dtype=q.dtype, device=q.device)
    _launch_bwd(flash_mha_bwd_dq, "vcd_flash_bwd_dq", (q, k, v, do), lse, di,
                (dq,), sm_scale, split)
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


def flash_mha_bwd_dkv(q, k, v, do, lse, di, sm_scale: float, split=None):
    """K4's dK/dV backward: (dk, dv). A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel. ``split``: on the float32 route, the
    split copies of q, k, v, do (``flash_mha_split``) that the dQ kernel
    shares; made here where not given."""
    if q.device.type == "cpu":
        return flash_mha_bwd_dkv_plain(q, k, v, do, lse, di, sm_scale)
    return _launch_bwd_dkv(q, k, v, do, lse, di, sm_scale, split=split)


flash_mha_bwd_dkv.launches = 0
# the launches among them on each route's Hopper kernels (``route``): bf16
# and float32 (split products) with head_dim 64, then with head_dim 16
flash_mha_bwd_dkv.wgmma_launches = 0
flash_mha_bwd_dkv.f32_launches = 0
flash_mha_bwd_dkv.d16_launches = 0
flash_mha_bwd_dkv.d16_f32_launches = 0


def flash_mha_bwd_dq(q, k, v, do, lse, di, sm_scale: float, split=None):
    """K4's dQ backward. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (``split`` as for ``flash_mha_bwd_dkv``)."""
    if q.device.type == "cpu":
        return flash_mha_bwd_dq_plain(q, k, v, do, lse, di, sm_scale)
    return _launch_bwd_dq(q, k, v, do, lse, di, sm_scale, split=split)


flash_mha_bwd_dq.launches = 0
flash_mha_bwd_dq.wgmma_launches = 0
flash_mha_bwd_dq.f32_launches = 0
flash_mha_bwd_dq.d16_launches = 0
flash_mha_bwd_dq.d16_f32_launches = 0


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
    dK/dV and the dQ kernel (on the float32 route after one split pass
    whose copies both read)."""

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
        split = (flash_mha_split(q, k, v, do) if q.device.type != "cpu"
                 and route(q.dtype, q.shape[-1]) in _SPLIT_ROUTES else None)
        dk, dv = flash_mha_bwd_dkv(*args, split=split)
        return flash_mha_bwd_dq(*args, split=split), dk, dv, None


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
# the launches among them on each route's Hopper kernels (``route``): bf16,
# and float32 on split products, with head_dim 64, then with head_dim 16
flash_mha.wgmma_launches = 0
flash_mha.f32_launches = 0
flash_mha.d16_launches = 0
flash_mha.d16_f32_launches = 0
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
