"""Which kernel a CUDA call of K2's forward, K2's weight gradient, K3 or
K4's forward takes, how K3's weights reach it, and what K1's wrapper hands
its kernel, checked on the CPU.

K3 and K4's forward each have a Hopper kernel (wgmma, TMA) for the main
paths' dtypes and widths (K3: bf16 and float32 up to 768) and the
mma.sync one for the rest; K3 has a second Hopper kernel, split into a
LayerNorm and two GEMMs, for bf16 and float32 at 1024 and 1536;
K2's forward has the CUDA-core stencil of ``dwconv_hopper.cu`` for bf16
and float32 at widths that divide by 32 and ``dwconv.cu`` for the rest,
and K2's weight gradient the CUDA-core reduction of
``dwconv_wgrad_hopper.cu`` for bf16 and float32 at those widths and
``dwconv_wgrad.cu`` for the rest.
The choice is a rule on dtype and width (``dwconv.route``,
``dwconv.wgrad_route``, ``convnext_mlp.route``,
``flash_attention.route``: K4 with head_dim 64 and with head_dim 16 on
Hopper kernels of its own in bf16 and, on split bf16 products, in
float32, forward and backward; the older kernels only where a caller
forces the route), and
both Hopper K3 kernels
read W1 and W2 in
nn.Linear's own layout, so a block that passes ``pwconv1.weight.t()`` hands
it the weight's storage with no copy. The launches are held here with the
C library swapped for a recorder (the kernels run only on a card, where
``chip_smoke.py`` holds them against their plain versions); the block with
transposed weight views is held against the JAX package's
``convnext_mlp_block`` run in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import bf16_ulp
from vision_collision_detection_tpu.ops.convnext_mlp_pallas import (
    convnext_mlp_block,
)
from vision_collision_detection_tpu_torch.models.backbones import convnext
from vision_collision_detection_tpu_torch.ops import _build
from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
from vision_collision_detection_tpu_torch.ops import dequant_pad as k1
from vision_collision_detection_tpu_torch.ops import dwconv as k2
from vision_collision_detection_tpu_torch.ops import flash_attention as fa

K3_NAMES = ("ln_w", "ln_b", "w1", "b1", "w2", "b2", "gamma")


@pytest.mark.parametrize("C", k3.KERNEL_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k3_route_rule(C, dtype):
    """bf16 and float32 take the Hopper kernel up to 768 and the split
    wgmma kernel at 1024 and 1536; no width of ``KERNEL_DIMS`` is left to
    the mma.sync kernel."""
    want = "wgmma" if C <= 768 else "wide"
    assert k3.route(dtype, C) == want


@pytest.mark.parametrize("C", [96, 128, 192, 256, 384, 512, 768, 1024, 1536,
                               48])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_route_rule(C, dtype):
    """Every ConvNeXt width (96 to 1536) in bf16 or float32 takes the Hopper
    stencil; a width that does not divide by 32 takes dwconv.cu."""
    want = "hopper" if C != 48 else "tile"
    assert k2.route(dtype, C) == want


@pytest.mark.parametrize("C", [96, 128, 768, 40])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_wgrad_route_rule(C, dtype):
    """bf16 and float32 at every width that divides by 32 take the Hopper
    reduction; a width that does not (40) takes dwconv_wgrad.cu."""
    want = "hopper" if C != 40 else "tile"
    assert k2.wgrad_route(dtype, C) == want


def _flash_want(dtype, head_dim):
    """Both head dims take a Hopper kernel of their own in both dtypes
    (float32 on split bf16 products): head_dim 16 the ``_d16`` routes."""
    want = "wgmma" if dtype == torch.bfloat16 else "f32_wgmma"
    return want + "_d16" if head_dim == 16 else want


@pytest.mark.parametrize("head_dim", [16, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_fwd_route_rule(head_dim, dtype):
    assert fa.route(dtype, head_dim) == _flash_want(dtype, head_dim)
    with pytest.raises(ValueError, match="head_dim"):
        fa.route(dtype, 32)


def _linears(C, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    lin1, lin2 = torch.nn.Linear(C, 4 * C), torch.nn.Linear(4 * C, C)
    with torch.no_grad():
        for lin in (lin1, lin2):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.1)
    return lin1.to(dtype), lin2.to(dtype)


@pytest.mark.parametrize("weight_dtype", [torch.bfloat16, torch.float32])
def test_kernel_weights_take_linear_storage(weight_dtype):
    """Both Hopper routes read nn.Linear's storage; the mma.sync route gets
    flax-layout copies."""
    lin1, lin2 = _linears(96, weight_dtype)
    for kernel_route in ("wgmma", "wide"):
        w1, w2 = k3.kernel_weights(lin1.weight.t(), lin2.weight.t(),
                                   kernel_route)
        assert w1.shape == (384, 96) and w2.shape == (96, 384)
        assert w1.is_contiguous() and w2.is_contiguous()
        assert w1.dtype == w2.dtype == torch.bfloat16
        assert torch.equal(w1, lin1.weight.to(torch.bfloat16))
        assert torch.equal(w2, lin2.weight.to(torch.bfloat16))
        if weight_dtype == torch.bfloat16:
            # the view's own storage, not a copy
            assert w1.data_ptr() == lin1.weight.data_ptr()
            assert w2.data_ptr() == lin2.weight.data_ptr()
    f1, f2 = k3.kernel_weights(lin1.weight.t(), lin2.weight.t(), "mma")
    assert f1.shape == (96, 384) and f1.is_contiguous()
    assert torch.equal(f1, lin1.weight.t().to(torch.bfloat16))
    assert torch.equal(f2, lin2.weight.t().to(torch.bfloat16))


class _Recorder:
    """Stands in for the kernel library: records each entry called and its
    arguments, returns 0 (no error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "lib", lambda: rec)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    return rec


def _k3_args(C, dtype, weight_dtype=torch.bfloat16, M=5):
    g = torch.Generator().manual_seed(C)
    lin1, lin2 = _linears(C, weight_dtype)
    x = torch.randn(M, C, generator=g).to(dtype)
    y = torch.randn(M, C, generator=g).to(dtype)
    params = dict(ln_w=torch.ones(C), ln_b=torch.zeros(C),
                  w1=lin1.weight.t(), b1=lin1.bias, w2=lin2.weight.t(),
                  b2=lin2.bias, gamma=torch.ones(C))
    return x, y, params, lin1, lin2


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("C", [96, 384, 768, 1024])
def test_k3_launch_takes_the_routed_entry_and_weights(recorder, C, train):
    """A bf16 call launches the entry of its route, ``vcd_convnext_mlp_wgmma``
    up to 768 and ``vcd_convnext_mlp_wide`` at 1024, with the Linear
    weights' own storage, and counts it under that route."""
    x, y, p, lin1, lin2 = _k3_args(C, torch.bfloat16)
    counter = k3.convnext_mlp_train if train else k3.convnext_mlp
    before = (counter.launches, counter.wgmma_launches, counter.wide_launches)
    launch = k3._launch_train if train else k3._launch_eval
    launch(x, y, approximate=True, **p)
    (name, args), = recorder.calls
    wide = C == 1024
    assert name == ("vcd_convnext_mlp_wide" if wide else
                    "vcd_convnext_mlp_wgmma")
    assert (counter.launches, counter.wgmma_launches,
            counter.wide_launches) == (before[0] + 1, before[1] + (not wide),
                                       before[2] + wide)
    w1_ptr, w2_ptr = args[4], args[6]
    assert (w1_ptr, w2_ptr) == (lin1.weight.data_ptr(),
                                lin2.weight.data_ptr())
    # eval: h_pre and m (and the wgmma kernel's t) null; train: given
    saved = args[12:14] if wide else args[10:13]
    assert all(s is not None for s in saved) == train
    assert all(s is None for s in saved) == (not train)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("C", [1024, 1536])
def test_k3_wide_launch_hands_its_entry_storage_and_scratch(recorder, C,
                                                            train):
    """``vcd_convnext_mlp_wide`` gets the Linear weights' own storage, its
    scratch t [M, C] and h [M, 4C] (t is the train variant's saved t),
    h_pre and m exactly when training, and all of its stages; its counter
    goes up by one."""
    M = 5
    x, y, p, lin1, lin2 = _k3_args(C, torch.bfloat16, M=M)
    counter = k3.convnext_mlp_train if train else k3.convnext_mlp
    before = counter.wide_launches
    got = (k3._launch_train if train else k3._launch_eval)(
        x, y, approximate=False, **p)
    (name, args), = recorder.calls
    assert name == "vcd_convnext_mlp_wide" and len(args) == 20
    assert counter.wide_launches == before + 1
    assert (args[4], args[6]) == (lin1.weight.data_ptr(),
                                  lin2.weight.data_ptr())
    out, t, h, h_pre, m = args[9:14]
    assert None not in (out, t, h) and t != h
    assert (h_pre is not None, m is not None) == (train, train)
    assert args[14:19] == (M, C, 0, 0, k3.WIDE_ALL)  # dtype code 0: bf16
    if train:
        out_t, t_t, h_pre_t, m_t = got
        assert (out, t, h_pre, m) == tuple(a.data_ptr() for a in got)
        assert t_t.shape == (M, C) and h_pre_t.shape == (M, 4 * C)
        assert m_t.shape == (M, C)
    else:
        assert out == got.data_ptr()


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("C", [1024, 1536])
def test_k3_float32_at_wide_widths_takes_the_wide_entry(recorder,
                                                        monkeypatch, C,
                                                        train):
    """float32 activations at 1024 and 1536 launch ``vcd_convnext_mlp_wide``
    with dtype code 1: x and out float32, its scratch t [M, C] and h
    [M, 4C] bf16, and in the train variant the saved t, h_pre and m in
    bf16, handed back as the variant's outputs; the Linear weights' own
    storage; its counter goes up by one."""
    M = 5
    seen = []
    wide = k3._wide

    def spy(ptrs, out, t, h, h_pre, m, *rest):
        seen.append((out, t, h, h_pre, m))
        return wide(ptrs, out, t, h, h_pre, m, *rest)

    monkeypatch.setattr(k3, "_wide", spy)
    x, y, p, lin1, lin2 = _k3_args(C, torch.float32, M=M)
    counter = k3.convnext_mlp_train if train else k3.convnext_mlp
    before = (counter.launches, counter.wide_launches)
    got = (k3._launch_train if train else k3._launch_eval)(
        x, y, approximate=True, **p)
    (name, args), = recorder.calls
    assert name == "vcd_convnext_mlp_wide" and len(args) == 20
    assert args[:2] == (x.data_ptr(), y.data_ptr())
    assert (args[4], args[6]) == (lin1.weight.data_ptr(),
                                  lin2.weight.data_ptr())
    assert args[14:19] == (M, C, 1, 1, k3.WIDE_ALL)  # dtype code 1: float32
    assert (counter.launches, counter.wide_launches) == (before[0] + 1,
                                                         before[1] + 1)
    ((out, t, h, h_pre, m),) = seen
    assert args[9:14] == tuple(None if a is None else a.data_ptr()
                               for a in (out, t, h, h_pre, m))
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert (t.dtype, h.dtype) == (torch.bfloat16, torch.bfloat16)
    assert t.shape == (M, C) and h.shape == (M, 4 * C)
    if train:
        assert (h_pre.dtype, m.dtype) == (torch.bfloat16, torch.bfloat16)
        assert h_pre.shape == (M, 4 * C) and m.shape == (M, C)
        assert tuple(a.data_ptr() for a in got) == tuple(
            a.data_ptr() for a in (out, t, h_pre, m))
    else:
        assert h_pre is None and m is None and got.data_ptr() == out.data_ptr()


def _k3_float32_launch(recorder, train):
    """One float32 call at C = 96 of the eval or train launcher: its entry,
    its arguments and the rise of its wgmma counter."""
    x, y, p, lin1, lin2 = _k3_args(96, torch.float32)
    counter = k3.convnext_mlp_train if train else k3.convnext_mlp
    before = counter.wgmma_launches
    (k3._launch_train if train else k3._launch_eval)(x, y, approximate=False,
                                                     **p)
    (name, args), = recorder.calls
    assert (args[4], args[6]) == (lin1.weight.data_ptr(),
                                  lin2.weight.data_ptr())
    return name, args, counter.wgmma_launches - before


def test_k3_float32_activations_take_the_wgmma_entry(recorder):
    """float32 activations at a width of the Hopper kernel launch
    ``vcd_convnext_mlp_wgmma`` (not the mma.sync entry) with dtype code 1
    and the Linear weights' own storage, and count under its route; the
    eval variant hands it a scratch t for its LayerNorm pass, and no h_pre
    or m."""
    name, args, rise = _k3_float32_launch(recorder, train=False)
    assert name == "vcd_convnext_mlp_wgmma" and args[-2] == 1
    assert args[13:16] == (5, 96, 0) and len(args) == 18 and rise == 1
    assert args[10] is not None and args[11:13] == (None, None)


def test_k3_float32_train_takes_the_wgmma_entry(recorder):
    """The train variant on float32 activations: the same entry and code,
    with its saved t, h_pre and m."""
    name, args, rise = _k3_float32_launch(recorder, train=True)
    assert name == "vcd_convnext_mlp_wgmma" and args[-2] == 1
    assert args[13:16] == (5, 96, 0) and rise == 1
    assert None not in args[10:13]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_function_forward_and_dx_take_the_routed_entry(recorder,
                                                          monkeypatch, dtype):
    """``_DwConv7x7``'s forward and its dx each launch the routed entry,
    ``vcd_dwconv7x7_hopper`` with the dtype code (0 bf16, 1 float32); the
    dx call gets the taps flipped in both axes and a zero bias, and both
    count as launches on the Hopper kernel."""
    C = 64
    seen = []
    launch = k2._launch_fwd

    def spy(x, w, b):
        seen.append((x, w, b))
        return launch(x, w, b)

    # the CPU tensors go down the card's path: launcher, then the recorder
    monkeypatch.setattr(k2, "_forward", spy)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 6, C, generator=g).to(dtype).requires_grad_(True)
    w = torch.randn(49, C, generator=g).to(dtype).requires_grad_(True)
    b = torch.randn(C, generator=g).to(dtype).requires_grad_(True)
    before = (k2.dwconv7x7.launches, k2.dwconv7x7.hopper_launches)
    y = k2.dwconv7x7(x, w, b)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert dx.shape == x.shape and dx.dtype == dtype
    names = [name for name, _ in recorder.calls
             if name.startswith("vcd_dwconv7x7")]
    assert names == ["vcd_dwconv7x7_hopper"] * 2
    assert (k2.dwconv7x7.launches, k2.dwconv7x7.hopper_launches) == (
        before[0] + 2, before[1] + 2)
    (fx, fw, fb), (gx, gw, gb) = seen
    assert fw is w and fb is b
    assert torch.equal(gw, w.detach().view(7, 7, C).flip(0, 1).reshape(49, C))
    assert torch.equal(gb, torch.zeros(C, dtype=dtype))
    for (name, args), (t_x, t_w, t_b) in zip(recorder.calls, seen):
        assert args[:3] == (t_x.data_ptr(), t_w.data_ptr(), t_b.data_ptr())
        assert args[4:9] == (2, 5, 6, C, int(dtype == torch.float32))


SMS = 132  # the H100's SMs, which size the wgrad kernels' partial sums


@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 96),
                                     (torch.bfloat16, 768),
                                     (torch.bfloat16, 40),
                                     (torch.float32, 96),
                                     (torch.float32, 768),
                                     (torch.float32, 40)])
def test_k2_wgrad_launch_takes_the_routed_entry(recorder, monkeypatch, dtype,
                                                C):
    """A bf16 or float32 call at a width that divides by 32 launches
    ``vcd_dwconv_wgrad_hopper`` with room for two blocks an SM shared among
    the C / 32 slabs, and counts it; another launches ``vcd_dwconv_wgrad``.
    Both get the dtype code (0 bf16, 1 float32) and write into a float32
    [49, C] dw."""
    monkeypatch.setattr(_build, "sm_count", lambda device: SMS)
    g = torch.Generator().manual_seed(C)
    x = torch.randn(2, 5, 6, C, generator=g).to(dtype)
    gy = torch.randn(2, 5, 6, C, generator=g).to(dtype)
    before = (k2.dwconv7x7_wgrad.launches, k2.dwconv7x7_wgrad.hopper_launches)
    dw = k2._launch_wgrad(x, gy)
    assert dw.shape == (49, C) and dw.dtype == torch.float32
    (name, args), = recorder.calls
    hopper = C % 32 == 0
    assert name == ("vcd_dwconv_wgrad_hopper" if hopper else
                    "vcd_dwconv_wgrad")
    assert (k2.dwconv7x7_wgrad.launches, k2.dwconv7x7_wgrad.hopper_launches) \
        == (before[0] + 1, before[1] + hopper)
    assert args[:2] == (x.data_ptr(), gy.data_ptr())
    assert args[3] == dw.data_ptr()
    assert args[4:8] == (2, 5, 6, C)
    if hopper:
        assert args[8] == -(-2 * SMS // (C // 32))
    assert args[9] == (0 if dtype == torch.bfloat16 else 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_function_dw_reaches_the_routed_entry(recorder, monkeypatch,
                                                 dtype):
    """``_DwConv7x7.backward``'s dw goes to the weight-gradient launcher with
    x as saved and the incoming gradient in x's dtype, and from there to the
    routed entry (``vcd_dwconv_wgrad_hopper`` for bf16 and float32)."""
    C = 64
    monkeypatch.setattr(_build, "sm_count", lambda device: SMS)
    monkeypatch.setattr(k2, "_forward", k2._launch_fwd)
    seen = []

    def spy(x, g):
        seen.append((x, g))
        return k2._launch_wgrad(x, g)

    spy.launches = spy.hopper_launches = 0
    # the CPU tensors go down the card's path: launcher, then the recorder
    monkeypatch.setattr(k2, "dwconv7x7_wgrad", spy)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 5, 6, C, generator=gen).to(dtype)
    w = torch.randn(49, C, generator=gen).to(dtype).requires_grad_(True)
    b = torch.randn(C, generator=gen).to(dtype).requires_grad_(True)
    y = k2.dwconv7x7(x, w, b)
    (dw,) = torch.autograd.grad(y, w, torch.ones_like(y))
    assert dw.shape == w.shape and dw.dtype == dtype
    ((sx, sg),) = seen
    assert sx.data_ptr() == x.data_ptr() and sg.dtype == x.dtype
    names = [name for name, _ in recorder.calls
             if name.startswith("vcd_dwconv_wgrad")]
    assert names == ["vcd_dwconv_wgrad_hopper"]
    assert (spy.launches, spy.hopper_launches) == (1, 1)
    (_, args), = [c for c in recorder.calls if c[0] == names[0]]
    assert args[:2] == (sx.data_ptr(), sg.data_ptr())
    assert args[9] == (0 if dtype == torch.bfloat16 else 1)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_k1_wrapper_passes_its_arguments_to_the_row_kernel(recorder,
                                                           out_dtype):
    """K1's wrapper hands ``vcd_dequant_pad`` the frames, a fresh [..., S,
    S, 3] output, the frame count, content sides, target side, the three
    scales a = 1/(255·std) and offsets b = −mean/std, and the dtype code;
    the launch counts."""
    mean, std = (0.45, 0.40, 0.35), (0.225, 0.25, 0.2)
    # meta tensors carry the shape past the CPU check to the kernel path
    # of the op's implementation (the op itself gives a meta tensor its
    # fake)
    u8 = torch.empty(2, 3, 120, 213, 3, dtype=torch.uint8, device="meta")
    before = k1.dequant_normalize_pad.launches
    out = k1._run(u8, 224, mean, std, out_dtype)
    assert out.shape == (2, 3, 224, 224, 3) and out.dtype == out_dtype
    assert k1.dequant_normalize_pad.launches == before + 1
    (name, args), = recorder.calls
    assert name == "vcd_dequant_pad"
    assert args[2:6] == (6, 120, 213, 224)
    a = [1.0 / (255.0 * s) for s in std]
    b = [-m / s for m, s in zip(mean, std)]
    assert args[6:12] == pytest.approx(a + b, rel=1e-12)
    assert args[12] == (0 if out_dtype == torch.bfloat16 else 1)


_FLASH_ENTRY_SUFFIX = {"wgmma": "_wgmma", "f32_wgmma": "_f32",
                       "wgmma_d16": "_wgmma_d16", "f32_wgmma_d16": "_f32_d16",
                       "mma": ""}
_FLASH_COUNTERS = ("wgmma_launches", "f32_launches", "d16_launches",
                   "d16_f32_launches")
_FLASH_ROUTE_COUNTER = dict(zip(("wgmma", "f32_wgmma", "wgmma_d16",
                                 "f32_wgmma_d16"), _FLASH_COUNTERS))
_FLASH_SPLIT_ROUTES = ("f32_wgmma", "f32_wgmma_d16")


@pytest.fixture
def flash_scratch(monkeypatch):
    """K4's launchers with ``_kernel_view`` passing CPU tensors through and
    each split scratch the split launcher allocates recorded."""
    monkeypatch.setattr(fa, "_kernel_view", lambda t, name, vectors=False: t)
    made = []
    real = fa._launch_split

    def launch_split(*args):
        made.append(real(*args))
        return made[-1]

    monkeypatch.setattr(fa, "_launch_split", launch_split)
    return made


def _flash_counts(fn):
    return (fn.launches,) + tuple(getattr(fn, c) for c in _FLASH_COUNTERS)


def _counted(before, route):
    """The counts after one launch on ``route``: ``launches`` and that
    route's own counter one up, the other routes' as they were."""
    mine = _FLASH_ROUTE_COUNTER.get(route)
    return (before[0] + 1,) + tuple(
        n + (c == mine) for n, c in zip(before[1:], _FLASH_COUNTERS))


def _split_call(recorder, split, operands):
    """The split pass's entry was called once with every operand, their
    strides and ``split``, bf16 [7 or 10, B, S, H, D], and head_dim."""
    B, S, H, D = operands[0].shape
    name, args = recorder.calls[0]
    assert name == "vcd_flash_split_f32"
    ptrs = tuple(t.data_ptr() for t in operands)
    assert args[:4] == ptrs + (None,) * (4 - len(operands))
    assert list(args[4]) == [x for t in operands for x in t.stride()[:3]]
    assert split.dtype == torch.bfloat16 and split.is_contiguous()
    assert tuple(split.shape) == (7 + 3 * (len(operands) == 4), B, S, H, D)
    assert args[5:10] == (split.data_ptr(), B, S, H, D)


@pytest.mark.parametrize("dtype,head_dim", [(torch.bfloat16, 64),
                                            (torch.bfloat16, 16),
                                            (torch.float32, 64),
                                            (torch.float32, 16)])
def test_flash_fwd_launch_takes_the_routed_entry(recorder, flash_scratch,
                                                 dtype, head_dim):
    """The forward launches its route's entry, counted under that route;
    float32 (either head_dim) first launches the split pass on q, k and v
    (7 parts: v in three) and hands ``vcd_flash_fwd_f32`` (``_f32_d16``)
    its scratch in their place, with no strides and no dtype code; bf16
    hands its ``_wgmma`` (``_wgmma_d16``) entry the tensors and their
    strides."""
    q = torch.randn(2, 8, 2, head_dim).to(dtype)
    k, v = torch.randn_like(q), torch.randn_like(q)
    before = _flash_counts(fa.flash_mha)
    splits = fa.flash_mha_split.launches
    o, lse = fa._launch_fwd(q, k, v, 0.125, need_lse=True)
    name, args = recorder.calls[-1]
    route = _flash_want(dtype, head_dim)
    split_route = route in _FLASH_SPLIT_ROUTES
    assert name == "vcd_flash_fwd" + _FLASH_ENTRY_SUFFIX[route]
    assert _flash_counts(fa.flash_mha) == _counted(before, route)
    assert fa.flash_mha_split.launches == splits + split_route
    assert o.shape == q.shape and o.dtype == dtype and lse.shape == (2, 2, 8)
    if split_route:
        split, = flash_scratch
        assert len(recorder.calls) == 2
        _split_call(recorder, split, (q, k, v))
        assert args == (split.data_ptr(), o.data_ptr(), lse.data_ptr(), 2, 8,
                        2, 0.125, 0)
        return
    assert len(recorder.calls) == 1 and not flash_scratch
    assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr())
    assert list(args[5]) == [x for t in (q, k, v) for x in t.stride()[:3]]
    assert args[6:9] == (2, 8, 2) and len(args) == 11


def _bwd_args(dtype, head_dim, B=2, S=8, H=2):
    g = torch.Generator().manual_seed(head_dim)
    q, k, v, do = (torch.randn(B, S, H, head_dim, generator=g).to(dtype)
                   for _ in range(4))
    return q, k, v, do, torch.zeros(B, H, S), torch.zeros(B, H, S)


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
@pytest.mark.parametrize("dtype,head_dim", [(torch.bfloat16, 64),
                                            (torch.bfloat16, 16),
                                            (torch.float32, 64),
                                            (torch.float32, 16)])
def test_flash_bwd_launch_takes_the_routed_entry(recorder, flash_scratch,
                                                 dtype, head_dim, kernel):
    """dK/dV and dQ launch their route's entry (``route``), counted under
    that route: bf16 ``*_wgmma`` (``*_wgmma_d16`` at head_dim 16), float32
    ``*_f32`` (``*_f32_d16``) after the split pass on q, k, v and do (10
    parts: v and do in three), whose scratch it reads in their place."""
    q, k, v, do, lse, di = _bwd_args(dtype, head_dim)
    fn = fa.flash_mha_bwd_dkv if kernel == "dkv" else fa.flash_mha_bwd_dq
    launch = fa._launch_bwd_dkv if kernel == "dkv" else fa._launch_bwd_dq
    before = _flash_counts(fn)
    outs = launch(q, k, v, do, lse, di, 0.125)
    outs = outs if kernel == "dkv" else (outs,)
    name, args = recorder.calls[-1]
    route = _flash_want(dtype, head_dim)
    assert name == f"vcd_flash_bwd_{kernel}" + _FLASH_ENTRY_SUFFIX[route]
    assert _flash_counts(fn) == _counted(before, route)
    n_out = len(outs)
    assert all(t.shape == q.shape and t.dtype == dtype for t in outs)
    B, S, H = q.shape[:3]
    if route in _FLASH_SPLIT_ROUTES:
        split, = flash_scratch
        assert len(recorder.calls) == 2
        _split_call(recorder, split, (q, k, v, do))
        assert args == ((split.data_ptr(), lse.data_ptr(), di.data_ptr())
                        + tuple(t.data_ptr() for t in outs)
                        + (B, S, H, 0.125, 0))
        return
    assert len(recorder.calls) == 1 and not flash_scratch
    assert args[:4] == tuple(t.data_ptr() for t in (q, k, v, do))
    assert args[4:6] == (lse.data_ptr(), di.data_ptr())
    assert args[6:6 + n_out] == tuple(t.data_ptr() for t in outs)
    assert list(args[6 + n_out]) == [x for t in (q, k, v, do)
                                     for x in t.stride()[:3]]
    rest = args[7 + n_out:]  # after the strides
    assert rest[:3] == (B, S, H) and len(rest) == 5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_forced_mma_route_takes_the_old_entries(recorder, flash_scratch,
                                                      monkeypatch, dtype):
    """The kernels the routes replaced stay reachable for a caller that
    forces the route to ``"mma"`` (the card's yardstick): their entries
    take head_dim and the dtype code (0 bf16, 1 float32) and count on
    ``launches`` alone."""
    monkeypatch.setattr(fa, "route", lambda dtype, head_dim: "mma")
    q, k, v, do, lse, di = _bwd_args(dtype, 16)
    code = 0 if dtype == torch.bfloat16 else 1
    before = {fn: _flash_counts(fn) for fn in (
        fa.flash_mha, fa.flash_mha_bwd_dkv, fa.flash_mha_bwd_dq)}
    fa._launch_fwd(q, k, v, 0.125, need_lse=True)
    fa._launch_bwd_dkv(q, k, v, do, lse, di, 0.125)
    fa._launch_bwd_dq(q, k, v, do, lse, di, 0.125)
    assert [name for name, _ in recorder.calls] == [
        "vcd_flash_fwd", "vcd_flash_bwd_dkv", "vcd_flash_bwd_dq"]
    fwd, dkv, dq = (args for _, args in recorder.calls)
    assert fwd[6:10] == (2, 8, 2, 16) and fwd[11] == code
    assert dkv[9:13] == (2, 8, 2, 16) and dkv[14] == code
    assert dq[8:12] == (2, 8, 2, 16) and dq[13] == code
    assert not flash_scratch
    for fn, counts in before.items():
        assert _flash_counts(fn) == _counted(counts, "mma")


@pytest.mark.parametrize("head_dim", [16, 64])
@pytest.mark.parametrize("kernel", ["dkv", "dq"])
def test_flash_bwd_reads_a_given_split(recorder, flash_scratch, kernel,
                                       head_dim):
    """A float32 backward kernel given the split copies launches no split
    pass and reads them; copies of another shape or dtype are refused."""
    q, k, v, do, lse, di = _bwd_args(torch.float32, head_dim)
    fn = fa.flash_mha_bwd_dkv if kernel == "dkv" else fa.flash_mha_bwd_dq
    launch = fa._launch_bwd_dkv if kernel == "dkv" else fa._launch_bwd_dq
    split = torch.empty((10,) + tuple(q.shape), dtype=torch.bfloat16)
    route = _flash_want(torch.float32, head_dim)
    before = _flash_counts(fn)
    launch(q, k, v, do, lse, di, 0.125, split=split)
    (name, args), = recorder.calls
    assert name == (f"vcd_flash_bwd_{kernel}" + _FLASH_ENTRY_SUFFIX[route])
    assert not flash_scratch
    assert args[0] == split.data_ptr()
    assert _flash_counts(fn) == _counted(before, route)
    for bad in (split[:7], split.float(), split.transpose(1, 2)):
        with pytest.raises(ValueError, match="split must be"):
            launch(q, k, v, do, lse, di, 0.125, split=bad)


@pytest.mark.parametrize("head_dim", [16, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_route_rule(recorder, flash_scratch, monkeypatch, head_dim,
                              dtype):
    """A whole pass through the autograd Function (meta tensors, the kernel
    library recorded) takes one route, ``route``'s, in both directions;
    on the float32 route the backward launches the split pass once, and
    its dK/dV and dQ kernels both read those copies."""
    given = []
    real = fa._split_of
    monkeypatch.setattr(fa, "_split_of", lambda split, *ops: (
        given.append(split is not None) or real(split, *ops)))
    q, k, v = (torch.empty(2, 8, 2, head_dim, dtype=dtype, device="meta",
                           requires_grad=True) for _ in range(3))
    o = fa.flash_mha(q, k, v, head_dim ** -0.5)
    torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    route = _flash_want(dtype, head_dim)
    sfx = _FLASH_ENTRY_SUFFIX[route]
    want = ["vcd_flash_fwd" + sfx, "vcd_flash_bwd_di",
            "vcd_flash_bwd_dkv" + sfx, "vcd_flash_bwd_dq" + sfx]
    split_route = route in _FLASH_SPLIT_ROUTES
    if split_route:
        want = want[:2] + ["vcd_flash_split_f32"] + want[2:]
        want.insert(0, "vcd_flash_split_f32")
    assert [name for name, _ in recorder.calls] == want
    assert given == ([False, True, True] if split_route else [])


@pytest.mark.parametrize("head_dim", [16, 64])
@pytest.mark.parametrize("with_do", [False, True])
def test_flash_split_plain_layout(with_do, head_dim):
    """The split copies in the order the float32 kernels read them: q, k
    in hi and lo, v and do in hi, lo and lo2, where hi = bf16(x),
    lo = bf16(x − hi), lo2 = bf16(x − hi − lo); on the CPU the wrapper
    gives the plain version."""
    g = torch.Generator().manual_seed(3)
    ops = [torch.randn(2, 5, 3, head_dim, generator=g) * 10.0 ** i
           for i in range(4 if with_do else 3)]
    split = fa.flash_mha_split(*ops)
    assert torch.equal(split, fa.flash_mha_split_plain(*ops))
    assert split.dtype == torch.bfloat16
    assert tuple(split.shape) == (10 if with_do else 7, 2, 5, 3, head_dim)
    at = 0
    for x, n in zip(ops, (2, 2, 3, 3)):
        parts = split[at:at + n].float()
        at += n
        assert torch.equal(parts[0], x.to(torch.bfloat16).float())
        assert torch.equal(parts[1], (x - parts[0]).to(torch.bfloat16).float())
        # what is left after the parts: 2^-17 of |x| with two, 2^-25 with
        # three (each part rounds what is left to 8 bits)
        left = (x.double() - parts.double().sum(0)).abs()
        assert bool((left <= x.double().abs() * 2.0 ** (1 - 8 * n)).all())


@pytest.mark.parametrize("with_do", [False, True])
def test_flash_split_refuses_what_the_kernels_do_not_take(recorder,
                                                          flash_scratch,
                                                          with_do):
    """The split pass takes float32 with head_dim 64 or 16 and one shape
    for every operand, else raises before any launch."""
    n = 4 if with_do else 3
    for shape, dtype, why in (((2, 8, 2, 64), torch.bfloat16,
                               "split pass takes"),
                              ((2, 8, 2, 16), torch.bfloat16,
                               "split pass takes"),
                              ((2, 8, 2, 32), torch.float32, "head_dim")):
        ops = [torch.zeros(shape, dtype=dtype) for _ in range(n)]
        with pytest.raises(ValueError, match=why):
            fa._launch_split(*ops)
    ops = [torch.zeros(2, 8, 2, 64) for _ in range(n)]
    ops[-1] = torch.zeros(2, 9, 2, 64)
    with pytest.raises(ValueError, match="one shape"):
        fa._launch_split(*ops)
    assert not recorder.calls


@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("C", [16, 32])
def test_block_with_linear_weight_views_matches_jax(C, approximate):
    """K3 given W1 and W2 as transposed views of nn.Linear weights, as the
    ConvNeXt block passes them, against the JAX package's
    ``convnext_mlp_block`` on the flax-layout weights, and bit-equal to the
    same call with contiguous flax-layout copies."""
    rng = np.random.default_rng(11 + C)
    x = rng.normal(size=(2, 4, 5, C)).astype(np.float32)
    y = rng.normal(size=(2, 4, 5, C)).astype(np.float32)
    p = dict(ln_w=1 + 0.1 * rng.normal(size=C), ln_b=0.1 * rng.normal(size=C),
             w1=rng.normal(0, C ** -0.5, (C, 4 * C)),
             b1=0.1 * rng.normal(size=4 * C),
             w2=rng.normal(0, (4 * C) ** -0.5, (4 * C, C)),
             b2=0.1 * rng.normal(size=C), gamma=rng.uniform(0.5, 1.5, C))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    ref = np.asarray(convnext_mlp_block(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16),
        *(jnp.asarray(p[k]) for k in K3_NAMES), approximate)).astype(
            np.float32)
    lin1, lin2 = torch.nn.Linear(C, 4 * C), torch.nn.Linear(4 * C, C)
    with torch.no_grad():
        lin1.weight.copy_(torch.from_numpy(p["w1"].T.copy()))
        lin2.weight.copy_(torch.from_numpy(p["w2"].T.copy()))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    views = dict(tp, w1=lin1.weight.t(), w2=lin2.weight.t())
    assert not views["w1"].is_contiguous()
    tx = torch.from_numpy(x).to(torch.bfloat16)
    ty = torch.from_numpy(y).to(torch.bfloat16)
    with torch.no_grad():
        got = k3.convnext_mlp(tx, ty, approximate=approximate, **views)
        flat = k3.convnext_mlp(tx, ty, approximate=approximate, **tp)
    assert torch.equal(got, flat)
    got = got.float().numpy()
    # as test_k3_plain_matches_pallas: 2 bf16 ulps of each output and 2 of
    # the largest, for rare h_pre rounding flips between the two GELUs
    bound = 2 * bf16_ulp(ref) + 2 * bf16_ulp(np.abs(ref).max())
    assert np.all(np.abs(got - ref) <= bound), np.abs(got - ref).max()


def test_convnext_block_passes_linear_views(monkeypatch):
    """The block's fused path hands K3 ``pwconv1.weight.t()`` and
    ``pwconv2.weight.t()``: views of the Linear weights, no copies."""
    seen = {}

    def spy(x, y, ln_w, ln_b, w1, b1, w2, b2, gamma, approximate):
        seen.update(w1=w1, w2=w2)
        return x

    monkeypatch.setattr(convnext, "convnext_mlp", spy)
    block = convnext.ConvNeXtBlock(32, fused_mlp=True).eval()
    with torch.no_grad():
        block(torch.randn(1, 7, 7, 32))
    assert seen["w1"].shape == (32, 128)
    assert seen["w1"].data_ptr() == block.pwconv1.weight.data_ptr()
    assert seen["w2"].data_ptr() == block.pwconv2.weight.data_ptr()
