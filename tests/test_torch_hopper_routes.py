"""Which kernel a CUDA call of K2's forward, K2's weight gradient, K3 or
K4's forward takes, how K3's weights reach it, and what K1's wrapper hands
its kernel, checked on the CPU.

K3 and K4's forward each have two CUDA kernels: a Hopper one (wgmma, TMA)
for the main paths' dtype and widths, and the mma.sync one for the rest;
K2's forward has the CUDA-core stencil of ``dwconv_hopper.cu`` for bf16
at widths that divide by 32 and ``dwconv.cu`` for the rest, and K2's
weight gradient the CUDA-core reduction of ``dwconv_wgrad_hopper.cu``
under the same rule and ``dwconv_wgrad.cu`` for the rest.
The choice is a rule on dtype and width (``dwconv.route``,
``dwconv.wgrad_route``, ``convnext_mlp.route``,
``flash_attention.fwd_route``), and the Hopper K3
reads W1 and W2 in
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
    want = ("wgmma" if dtype == torch.bfloat16 and C not in (1024, 1536)
            else "mma")
    assert k3.route(dtype, C) == want


@pytest.mark.parametrize("C", [96, 128, 192, 256, 384, 512, 768, 1024, 1536,
                               48])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_route_rule(C, dtype):
    """Every ConvNeXt width (96 to 1536) in bf16 takes the Hopper stencil;
    float32, and a width that does not divide by 32, take dwconv.cu."""
    want = "hopper" if dtype == torch.bfloat16 and C != 48 else "tile"
    assert k2.route(dtype, C) == want


@pytest.mark.parametrize("C", [96, 128, 768, 40])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_wgrad_route_rule(C, dtype):
    """bf16 at every width that divides by 32 takes the Hopper reduction;
    float32, and a width that does not (40), take dwconv_wgrad.cu."""
    want = "hopper" if dtype == torch.bfloat16 and C != 40 else "tile"
    assert k2.wgrad_route(dtype, C) == want


@pytest.mark.parametrize("head_dim", [16, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_fwd_route_rule(head_dim, dtype):
    want = "wgmma" if (dtype, head_dim) == (torch.bfloat16, 64) else "mma"
    assert fa.fwd_route(dtype, head_dim) == want


def _linears(C, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    lin1, lin2 = torch.nn.Linear(C, 4 * C), torch.nn.Linear(4 * C, C)
    with torch.no_grad():
        for lin in (lin1, lin2):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.1)
    return lin1.to(dtype), lin2.to(dtype)


@pytest.mark.parametrize("weight_dtype", [torch.bfloat16, torch.float32])
def test_kernel_weights_take_linear_storage(weight_dtype):
    lin1, lin2 = _linears(96, weight_dtype)
    w1, w2 = k3.kernel_weights(lin1.weight.t(), lin2.weight.t(), "wgmma")
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
    """A bf16 call at a Hopper width launches ``vcd_convnext_mlp_wgmma``
    with the Linear weights' own storage and counts it; another width
    launches the mma.sync entry with flax-layout copies."""
    x, y, p, lin1, lin2 = _k3_args(C, torch.bfloat16)
    counter = k3.convnext_mlp_train if train else k3.convnext_mlp
    before, before_w = counter.launches, counter.wgmma_launches
    launch = k3._launch_train if train else k3._launch_eval
    launch(x, y, approximate=True, **p)
    (name, args), = recorder.calls
    hopper = C in k3.WGMMA_DIMS
    assert name == ("vcd_convnext_mlp_wgmma" if hopper else
                    "vcd_convnext_mlp_train" if train else "vcd_convnext_mlp")
    assert counter.launches == before + 1
    assert counter.wgmma_launches == before_w + hopper
    w1_ptr, w2_ptr = args[4], args[6]
    if hopper:
        assert (w1_ptr, w2_ptr) == (lin1.weight.data_ptr(),
                                    lin2.weight.data_ptr())
        # eval: t, h_pre and m null; train: all three given
        saved = args[10:13]
        assert all(s is not None for s in saved) == train
        assert all(s is None for s in saved) == (not train)
    else:
        assert w1_ptr != lin1.weight.data_ptr()


def test_k3_float32_activations_take_the_mma_entry(recorder):
    x, y, p, _, _ = _k3_args(96, torch.float32)
    k3._launch_eval(x, y, approximate=False, **p)
    (name, args), = recorder.calls
    assert name == "vcd_convnext_mlp" and args[-2] == 1  # dtype code float32


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_function_forward_and_dx_take_the_routed_entry(recorder,
                                                          monkeypatch, dtype):
    """``_DwConv7x7``'s forward and its dx each launch the routed entry:
    ``vcd_dwconv7x7_hopper`` for bf16, ``vcd_dwconv7x7`` (with its dtype
    code) for float32; the dx call gets the taps flipped in both axes and a
    zero bias, and both count as launches."""
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
    hopper = dtype == torch.bfloat16
    want = "vcd_dwconv7x7_hopper" if hopper else "vcd_dwconv7x7"
    assert names == [want, want]
    assert (k2.dwconv7x7.launches, k2.dwconv7x7.hopper_launches) == (
        before[0] + 2, before[1] + 2 * hopper)
    (fx, fw, fb), (gx, gw, gb) = seen
    assert fw is w and fb is b
    assert torch.equal(gw, w.detach().view(7, 7, C).flip(0, 1).reshape(49, C))
    assert torch.equal(gb, torch.zeros(C, dtype=dtype))
    for (name, args), (t_x, t_w, t_b) in zip(recorder.calls, seen):
        assert args[:3] == (t_x.data_ptr(), t_w.data_ptr(), t_b.data_ptr())
        assert args[4:8] == (2, 5, 6, C)
        if not hopper:
            assert args[8] == 1  # dtype code float32


SMS = 132  # the H100's SMs, which size the wgrad kernels' partial sums


@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 96),
                                     (torch.bfloat16, 768),
                                     (torch.bfloat16, 40),
                                     (torch.float32, 96)])
def test_k2_wgrad_launch_takes_the_routed_entry(recorder, monkeypatch, dtype,
                                                C):
    """A bf16 call at a width that divides by 32 launches
    ``vcd_dwconv_wgrad_hopper`` with room for two blocks an SM shared among
    the C / 32 slabs, and counts it; another launches ``vcd_dwconv_wgrad``
    with its dtype code. Both write into a float32 [49, C] dw."""
    monkeypatch.setattr(_build, "sm_count", lambda device: SMS)
    g = torch.Generator().manual_seed(C)
    x = torch.randn(2, 5, 6, C, generator=g).to(dtype)
    gy = torch.randn(2, 5, 6, C, generator=g).to(dtype)
    before = (k2.dwconv7x7_wgrad.launches, k2.dwconv7x7_wgrad.hopper_launches)
    dw = k2._launch_wgrad(x, gy)
    assert dw.shape == (49, C) and dw.dtype == torch.float32
    (name, args), = recorder.calls
    hopper = dtype == torch.bfloat16 and C % 32 == 0
    assert name == ("vcd_dwconv_wgrad_hopper" if hopper else
                    "vcd_dwconv_wgrad")
    assert (k2.dwconv7x7_wgrad.launches, k2.dwconv7x7_wgrad.hopper_launches) \
        == (before[0] + 1, before[1] + hopper)
    assert args[:2] == (x.data_ptr(), gy.data_ptr())
    assert args[3] == dw.data_ptr()
    assert args[4:8] == (2, 5, 6, C)
    if hopper:
        assert args[8] == -(-2 * SMS // (C // 32))
    else:
        assert args[9] == (0 if dtype == torch.bfloat16 else 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_function_dw_reaches_the_routed_entry(recorder, monkeypatch,
                                                 dtype):
    """``_DwConv7x7.backward``'s dw goes to the weight-gradient launcher with
    x as saved and the incoming gradient in x's dtype, and from there to the
    routed entry (``vcd_dwconv_wgrad_hopper`` for bf16)."""
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
    hopper = dtype == torch.bfloat16
    assert names == ["vcd_dwconv_wgrad_hopper" if hopper else
                     "vcd_dwconv_wgrad"]
    assert (spy.launches, spy.hopper_launches) == (1, int(hopper))
    (_, args), = [c for c in recorder.calls if c[0] == names[0]]
    assert args[:2] == (sx.data_ptr(), sg.data_ptr())


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_k1_wrapper_passes_its_arguments_to_the_row_kernel(recorder,
                                                           out_dtype):
    """K1's wrapper hands ``vcd_dequant_pad`` the frames, a fresh [..., S,
    S, 3] output, the frame count, content sides, target side, the three
    scales a = 1/(255·std) and offsets b = −mean/std, and the dtype code;
    the launch counts."""
    mean, std = (0.45, 0.40, 0.35), (0.225, 0.25, 0.2)
    # meta tensors carry the shape past the CPU check to the kernel path
    u8 = torch.empty(2, 3, 120, 213, 3, dtype=torch.uint8, device="meta")
    before = k1.dequant_normalize_pad.launches
    out = k1.dequant_normalize_pad(u8, 224, mean, std, out_dtype)
    assert out.shape == (2, 3, 224, 224, 3) and out.dtype == out_dtype
    assert k1.dequant_normalize_pad.launches == before + 1
    (name, args), = recorder.calls
    assert name == "vcd_dequant_pad"
    assert args[2:6] == (6, 120, 213, 224)
    a = [1.0 / (255.0 * s) for s in std]
    b = [-m / s for m, s in zip(mean, std)]
    assert args[6:12] == pytest.approx(a + b, rel=1e-12)
    assert args[12] == (0 if out_dtype == torch.bfloat16 else 1)


@pytest.mark.parametrize("dtype,head_dim", [(torch.bfloat16, 64),
                                            (torch.bfloat16, 16),
                                            (torch.float32, 64)])
def test_flash_fwd_launch_takes_the_routed_entry(recorder, monkeypatch,
                                                 dtype, head_dim):
    monkeypatch.setattr(fa, "_kernel_view", lambda t, name, vectors=False: t)
    q = torch.randn(2, 8, 2, head_dim).to(dtype)
    before = fa.flash_mha.wgmma_launches
    o, lse = fa._launch_fwd(q, q, q, 0.125, need_lse=True)
    (name, args), = recorder.calls
    hopper = (dtype, head_dim) == (torch.bfloat16, 64)
    assert name == ("vcd_flash_fwd_wgmma" if hopper else "vcd_flash_fwd")
    assert fa.flash_mha.wgmma_launches == before + hopper
    assert o.shape == q.shape and lse.shape == (2, 2, 8)


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
