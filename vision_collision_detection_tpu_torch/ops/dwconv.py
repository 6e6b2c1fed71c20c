"""K2: depthwise 7×7 convolution, stride 1, SAME, + bias, NHWC, with its
gradient.

Replaces the TPU kernels of ``vision_collision_detection_tpu/ops/dwconv_pallas.py``
``dwconv7x7``: the forward ``_run_fwd`` (``_fwd_kernel``) and the weight
gradient ``_run_wgrad`` (``_wgrad_kernel``), wired into ``jax.custom_vjp``
there and into the ``torch.autograd.Function`` ``_DwConv7x7`` here.

- The forward has two kernels, chosen by ``route``: for bf16 or float32
  activations with C a multiple of 32 (every ConvNeXt width)
  ``ops/csrc/dwconv_hopper.cu``, a CUDA-core stencil (a persistent grid of
  32-channel slabs, bands copied by cp.async while the last band's FMAs
  run: bf16 staged and converted to float32 once, float32 into two
  alternating tiles; 2×7 or 2×8 outputs a thread); for other widths
  ``ops/csrc/dwconv.cu`` (16×8 output tiles), which stays as the card's
  yardstick. Both mask the 3-pixel halo while loading instead of padding
  the input in device memory, and both sum the taps in the same order, so
  on float32 they agree bit for bit. The bound on the H100 in bf16 is
  operations: each of the flagship forward's 18 launches reads x and
  writes y once (≈ 1.7 GB over the 18 at B=8, ≈ 0.51 ms at 3.35 TB/s), but
  its 98 float32 flops per output (≈ 42 GFLOP over the 18) take ≈ 0.63 ms
  on the CUDA cores at 67 TFLOP/s. In float32 the bytes double and bound
  it (≈ 1.0 ms over the 18).
- The weight gradient has two kernels, chosen by ``wgrad_route`` (the
  forward's rule): for bf16 or float32 x and g with C a multiple of 32
  ``ops/csrc/dwconv_wgrad_hopper.cu``, the dual of the forward's stencil (a
  persistent grid of 32-channel slabs, each thread's 49 float32 sums of a
  channel pair in registers, bands in a two-deep cp.async ring in x's
  dtype, bf16 converted in registers as it is read, float32 read as it is,
  shorter bands for float32's larger pixels); for other widths
  ``ops/csrc/dwconv_wgrad.cu`` (8×8 tiles), which stays as the card's
  yardstick. Both write float32 ``dw[49, C]`` from per-block partial sums
  added in a fixed order, so two runs agree bit for bit (the two kernels
  partition the sums differently, so they do not agree bit for bit with
  each other). The bound in bf16 is operations too: 98 flops per element
  of x (≈ 42 GFLOP over a training step's 18 launches at B=8, ≈ 0.63 ms)
  against ≈ 1.7 GB read (≈ 0.51 ms); in float32 the bytes double (≈ 3.4
  GB, ≈ 1.0 ms) and bound it.

The backward is the JAX ``_dwconv_bwd``: dx is the forward kernel run on
the incoming gradient with the taps flipped in both axes and a zero bias,
rounded to x's dtype; dw comes from the weight-gradient kernel and db is
Σg in float32 (summed from g as it is, with no float32 copy of g), both
cast to w's dtype.

Weights come as ``[49, C]`` (tap ``dy*7 + dx`` major), the TPU kernel's
layout. Accumulation is float32 whatever the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vision_collision_detection_tpu_torch.ops import _build

K = 7
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
# Blocks of the weight-gradient kernel per SM, over all channel slabs.
_WGRAD_BLOCKS_PER_SM = 4
_WGRAD_TILE = (8, 8)
_WGRAD_SLAB = 32
# Channels per block of the Hopper kernels: C must divide by it.
HOPPER_SLAB = 32


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    if x.dim() != 4:
        raise ValueError(f"expected NHWC x, got shape {tuple(x.shape)}")
    C = x.shape[-1]
    if tuple(w.shape) != (K * K, C) or tuple(b.shape) != (C,):
        raise ValueError(
            f"w must be [49, {C}] and b [{C}], got {tuple(w.shape)}, "
            f"{tuple(b.shape)}")
    if w.dtype != x.dtype or b.dtype != x.dtype:
        raise ValueError(f"x, w, b dtypes differ: {x.dtype}, {w.dtype}, {b.dtype}")


def dwconv7x7_plain(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: ``F.conv2d(groups=C)`` on float32-cast
    inputs, cast back to x's dtype. x [N,H,W,C], w [49,C], b [C]."""
    _check(x, w, b)
    C = x.shape[-1]
    weight = w.to(torch.float32).t().reshape(C, 1, K, K)
    y = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2), weight,
                 b.to(torch.float32), padding=K // 2, groups=C)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def route(dtype: torch.dtype, C: int) -> str:
    """Which forward kernel a CUDA call takes: ``"hopper"``
    (``dwconv_hopper.cu``) for bf16 or float32 activations with C a
    multiple of ``HOPPER_SLAB``, else ``"tile"`` (``dwconv.cu``)."""
    return "hopper" if C % HOPPER_SLAB == 0 else "tile"


def _launch_fwd(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """The forward kernel of ``route`` on CUDA tensors (bf16 or float32, C
    even, all contiguous)."""
    N, H, W, C = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"dwconv7x7 kernel takes bf16 or float32, got {x.dtype}")
    if C % 2:
        raise ValueError(f"dwconv7x7 kernel needs an even channel count, got {C}")
    # channel pairs are read and written as one value of twice the size
    for t, name in ((x, "x"), (w, "w"), (b, "b")):
        _build.require_cuda(t, name, align=2 * x.element_size())
    out = torch.empty_like(x)
    stream = _build.stream_ptr(x.device)
    if route(x.dtype, C) == "hopper":
        # x is copied 16 bytes (8 channels) at a time
        _build.require_cuda(x, "x", align=16)
        err = _build.lib().vcd_dwconv7x7_hopper(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            N, H, W, C, _DTYPE_CODE[x.dtype], stream)
        _build.check(err, "vcd_dwconv7x7_hopper")
        dwconv7x7.hopper_launches += 1
    else:
        err = _build.lib().vcd_dwconv7x7(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            N, H, W, C, _DTYPE_CODE[x.dtype], stream)
        _build.check(err, "vcd_dwconv7x7")
    dwconv7x7.launches += 1
    return out


def hopper_geometry(N: int, H: int, W: int, C: int,
                    dtype: torch.dtype = torch.bfloat16) -> dict:
    """The launch ``dwconv_hopper.cu`` makes for an [N, H, W, C] input of
    ``dtype``, read from the library without launching (needs the card)."""
    import ctypes

    geo = (ctypes.c_int * 10)()
    _build.check(_build.lib().vcd_dwconv7x7_hopper_geometry(
        N, H, W, C, _DTYPE_CODE[dtype], geo), "vcd_dwconv7x7_hopper_geometry")
    keys = ("columns_per_thread", "slots", "frames", "rows", "cols",
            "groups", "items_per_slab", "grid", "smem_bytes", "bands")
    return dict(zip(keys, list(geo)))


def _forward(x, w, b):
    if x.device.type == "cpu":
        return dwconv7x7_plain(x, w, b)
    return _launch_fwd(x, w, b)


def dwconv7x7_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the weight-gradient kernel: for each of the
    49 taps, Σ over N, H, W of the zero-padded x shifted by the tap times
    g, in float32. x, g [N,H,W,C] → float32 [49, C]."""
    if x.shape != g.shape or x.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} must be "
                         "the same NHWC shape")
    _, H, W, _ = x.shape
    p = K // 2
    xp = F.pad(x.to(torch.float32), (0, 0, p, p, p, p))
    gf = g.to(torch.float32)
    return torch.stack([(xp[:, dy:dy + H, dx:dx + W, :] * gf).sum((0, 1, 2))
                        for dy in range(K) for dx in range(K)])


def wgrad_route(dtype: torch.dtype, C: int) -> str:
    """Which weight-gradient kernel a CUDA call takes: ``"hopper"``
    (``dwconv_wgrad_hopper.cu``) for bf16 or float32 x and g with C a
    multiple of ``HOPPER_SLAB``, else ``"tile"`` (``dwconv_wgrad.cu``)."""
    return "hopper" if C % HOPPER_SLAB == 0 else "tile"


def _wgrad_hopper_parts(device, C: int) -> int:
    """Rows of partial sums the Hopper kernel may use: at most two blocks an
    SM, shared among the C / 32 slabs (the kernel takes no more)."""
    return max(1, -(-2 * _build.sm_count(device) // (C // HOPPER_SLAB)))


def _launch_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight-gradient kernel of ``wgrad_route`` on CUDA tensors (bf16
    or float32, the same dtype, C a multiple of 8, contiguous)."""
    if x.shape != g.shape or x.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} must be "
                         "the same NHWC shape")
    if x.dtype not in _DTYPE_CODE or g.dtype != x.dtype:
        raise ValueError(f"dwconv7x7_wgrad kernel takes x, g both bf16 or "
                         f"both float32, got {x.dtype}, {g.dtype}")
    N, H, W, C = x.shape
    if C % 8:
        raise ValueError(f"dwconv7x7_wgrad kernel needs C % 8 == 0, got {C}")
    # x and g are read 8 channels at a time
    _build.require_cuda(x, "x", align=16)
    _build.require_cuda(g, "g", align=16)
    dw = torch.empty(K * K, C, dtype=torch.float32, device=x.device)
    stream = _build.stream_ptr(x.device)
    if wgrad_route(x.dtype, C) == "hopper":
        parts = _wgrad_hopper_parts(x.device, C)
        partial = torch.empty(parts, K * K, C, dtype=torch.float32,
                              device=x.device)
        err = _build.lib().vcd_dwconv_wgrad_hopper(
            x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
            N, H, W, C, parts, _DTYPE_CODE[x.dtype], stream)
        _build.check(err, "vcd_dwconv_wgrad_hopper")
        dwconv7x7_wgrad.hopper_launches += 1
    else:
        tiles = N * -(-H // _WGRAD_TILE[0]) * -(-W // _WGRAD_TILE[1])
        slabs = -(-C // _WGRAD_SLAB)
        parts = max(1, min(tiles, 65535, -(-_WGRAD_BLOCKS_PER_SM
                                           * _build.sm_count(x.device)
                                           // slabs)))
        partial = torch.empty(parts, K * K, C, dtype=torch.float32,
                              device=x.device)
        err = _build.lib().vcd_dwconv_wgrad(
            x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
            N, H, W, C, parts, _DTYPE_CODE[x.dtype], stream)
        _build.check(err, "vcd_dwconv_wgrad")
    dwconv7x7_wgrad.launches += 1
    return dw


def wgrad_hopper_geometry(N: int, H: int, W: int, C: int,
                          dtype: torch.dtype = torch.bfloat16) -> dict:
    """The launch ``dwconv_wgrad_hopper.cu`` makes for an [N, H, W, C]
    input of ``dtype``, read from the library without launching (needs the
    card)."""
    import ctypes

    geo = (ctypes.c_int * 10)()
    _build.check(_build.lib().vcd_dwconv_wgrad_hopper_geometry(
        N, H, W, C, _wgrad_hopper_parts(torch.device("cuda"), C),
        _DTYPE_CODE[dtype], geo), "vcd_dwconv_wgrad_hopper_geometry")
    keys = ("columns_per_thread", "slots", "frames", "rows", "cols",
            "strips", "items_per_slab", "grid", "smem_bytes", "bands")
    return dict(zip(keys, list(geo)))


def dwconv7x7_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K2's weight gradient, float32 [49, C]. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel of ``wgrad_route``
    (``hopper_launches`` counts those that took
    ``dwconv_wgrad_hopper.cu``)."""
    if x.device.type == "cpu":
        return dwconv7x7_wgrad_plain(x, g)
    return _launch_wgrad(x, g)


dwconv7x7_wgrad.launches = 0
dwconv7x7_wgrad.hopper_launches = 0


class _DwConv7x7(torch.autograd.Function):
    """K2 with the JAX package's ``custom_vjp`` backward."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _forward(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        C = w.shape[-1]
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # stride-1 SAME depthwise conv is self-transpose under a flip
            wf = w.view(K, K, C).flip(0, 1).reshape(K * K, C).to(g.dtype)
            dx = _forward(g, wf.contiguous(),
                          torch.zeros(C, dtype=g.dtype, device=g.device))
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = dwconv7x7_wgrad(x.contiguous(), g.to(x.dtype)).to(w.dtype)
        if ctx.needs_input_grad[2]:
            # summed in float32 as read: no float32 copy of g
            db = g.sum((0, 1, 2), dtype=torch.float32).to(w.dtype)
        return dx, dw, db


def dwconv7x7(x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """K2. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel of ``route`` (``hopper_launches`` counts those that took
    ``dwconv_hopper.cu``). Where a gradient is needed, the call goes through ``_DwConv7x7``,
    whose backward launches the forward kernel once more (dx) and the
    weight-gradient kernel. Otherwise the call is the op ``vcd::dwconv7x7``
    (``ops/library.py``), whose implementation is ``_forward``, so that
    ``torch.export`` can trace it."""
    _check(x, w, b)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return _DwConv7x7.apply(x, w, b)
    from vision_collision_detection_tpu_torch.ops import library

    return library.dwconv7x7(x, w, b)


dwconv7x7.launches = 0
dwconv7x7.hopper_launches = 0
