"""The port's ConvNeXt backbone against the flax one on bridged weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import randomize_params
from vision_collision_detection_tpu.models.backbones.convnext import (
    ConvNeXt as FlaxConvNeXt,
)
from vision_collision_detection_tpu_torch.models.backbones import convnext
from vision_collision_detection_tpu_torch.models.convert import (
    from_flax_params,
    load_flax_params,
)

DEPTHS, DIMS = (1, 1, 1, 1), (16, 32, 64, 128)


def _flax(gelu_approximate, apply_head_norm, dtype=jnp.float32):
    return FlaxConvNeXt(depths=DEPTHS, dims=DIMS, dtype=dtype,
                        gelu_approximate=gelu_approximate,
                        apply_head_norm=apply_head_norm)


def _port(gelu_approximate, apply_head_norm, dtype=torch.float32, **switches):
    return convnext.ConvNeXt(DEPTHS, DIMS, apply_head_norm=apply_head_norm,
                             gelu_approximate=gelu_approximate, dtype=dtype,
                             **switches).eval()


def _blocks(model):
    return [m for m in model.modules()
            if isinstance(m, convnext.ConvNeXtBlock)]


def _params(model, x, seed):
    init = model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return randomize_params(jax.device_get(init), np.random.default_rng(seed))


@pytest.mark.parametrize("apply_head_norm", [True, False])
@pytest.mark.parametrize("gelu_approximate", [True, False])
def test_stock_path_matches_flax_default_fp32(gelu_approximate,
                                              apply_head_norm):
    x = np.random.default_rng(0).normal(size=(3, 32, 32, 3)).astype(np.float32)
    fm = _flax(gelu_approximate, apply_head_norm)
    params = _params(fm, x, seed=1)
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    tm = _port(gelu_approximate, apply_head_norm,
               dwconv_kernel=False, fused_mlp=False)
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, DIMS[-1])
    # tolerance: float32 convolutions and products summed in other orders
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_kernel_path_fp32_matches_stock_path_to_bf16_level():
    """Both switches on (K3 asked for explicitly: in float32 the default is
    the stock chain): K2's plain version is float32-exact, K3's rounds t,
    h_pre and h to bf16 as the kernel does."""
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    params = _params(_flax(True, True), x, seed=3)
    stock, fused = _port(True, True, dwconv_kernel=False, fused_mlp=False), \
        _port(True, True, fused_mlp=True)
    assert all(b.use_fused_mlp for b in _blocks(fused))
    load_flax_params(stock, params)
    load_flax_params(fused, params)
    assert fused.stage0_block0.dwconv.weight.shape == (49, DIMS[0])
    with torch.no_grad():
        a, b = stock(torch.from_numpy(x)), fused(torch.from_numpy(x))
    # tolerance: bf16 roundings inside the MLP of 4 blocks, head-normed
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=0.1)
    assert float((a - b).abs().mean()) < 0.02


@pytest.mark.parametrize("kernels", [False, True], ids=["stock", "kernels"])
@pytest.mark.parametrize("hw", [(40, 40), (38, 38), (36, 32)],
                         ids=["40x40", "38x38", "36x32"])
def test_same_padding_matches_flax_at_sizes_not_divisible_by_32(hw, kernels):
    """flax pads the stem and downsample convolutions as ``SAME``: at 38
    the 4×4/4 stem takes (1, 1), at 40 the last stage is 2×2 after (0, 1)
    on 3 rows, smaller than the 7×7 kernel, so only the halo keeps it right."""
    x = np.random.default_rng(6).normal(size=(2, *hw, 3)).astype(np.float32)
    fm = _flax(True, True)
    params = _params(fm, x, seed=7)
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    switches = (dict(fused_mlp=True) if kernels
                else dict(dwconv_kernel=False, fused_mlp=False))
    tm = _port(True, True, **switches)
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, DIMS[-1]) and np.isfinite(got).all()
    if kernels:
        # tolerance: K3's plain version rounds t, h_pre and h to bf16 in 4
        # blocks, head-normed (the kernel path's bound above)
        np.testing.assert_allclose(got, ref, rtol=0, atol=0.1)
        assert float(np.abs(got - ref).mean()) < 0.02
    else:
        # tolerance: float32 convolutions and products summed in other orders
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_convnext_tiny_at_112_matches_flax():
    """The frame size ``train/notebook.py`` suggests: stages of 28, 14, 7
    and 4 (the last after a (0, 1) pad), stock path, float32."""
    from vision_collision_detection_tpu.models.backbones.convnext import (
        convnext_tiny as flax_tiny,
    )

    x = np.random.default_rng(8).normal(size=(1, 112, 112, 3)).astype(
        np.float32)
    fm = flax_tiny(dtype=jnp.float32)
    params = _params(fm, x, seed=9)
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    tm = convnext.convnext_tiny(dtype=torch.float32, dwconv_kernel=False,
                                fused_mlp=False).eval()
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 768)
    # tolerance: float32 convolutions and products summed in other orders
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_registry_builds_tiny_with_bridged_shapes():
    from vision_collision_detection_tpu_torch.models.backbones import (
        build_backbone,
        feature_dim,
    )

    m = build_backbone("convnext_tiny", dwconv_kernel=False)
    assert feature_dim("convnext_tiny") == 768
    assert sum(1 for n in m.state_dict() if n.endswith("gamma")) == 18
    assert m.stage2_block8.dwconv.weight.shape == (384, 1, 7, 7)


def test_bridge_rejects_unknown_and_missing_leaves():
    x = np.zeros((1, 32, 32, 3), np.float32)
    params = _params(_flax(True, True), x, seed=4)
    bad = dict(params, extra={"weird": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        from_flax_params(bad)
    missing = {k: v for k, v in params.items() if k != "head_norm"}
    with pytest.raises(RuntimeError, match="Missing"):
        load_flax_params(_port(True, True), missing)


def test_fused_mlp_default_follows_dtype():
    """K3 is the default on bf16 activations only; an explicit switch wins
    in either dtype. K2's default and the parameter layout do not depend on
    the dtype."""
    assert convnext.fused_mlp_default(torch.bfloat16)
    assert not convnext.fused_mlp_default(torch.float32)
    for dtype, want in ((torch.bfloat16, True), (torch.float32, False)):
        block = convnext.ConvNeXtBlock(32, dtype=dtype)
        assert block.use_fused_mlp is want and block.use_dwconv_kernel
        assert block.dwconv.weight.shape == (49, 32)
        for switch in (True, False):
            assert convnext.ConvNeXtBlock(
                32, dtype=dtype, fused_mlp=switch).use_fused_mlp is switch
    f32, b16 = (convnext.convnext_tiny(dtype=dt) for dt in (torch.float32,
                                                            torch.bfloat16))
    assert not any(b.use_fused_mlp for b in _blocks(f32))
    assert all(b.use_fused_mlp for b in _blocks(b16))
    sd32, sd16 = f32.state_dict(), b16.state_dict()
    assert {k: v.shape for k, v in sd32.items()} == {
        k: v.shape for k, v in sd16.items()}


def test_default_switches_fp32_match_flax_default():
    """A float32 ConvNeXt with default switches computes what the JAX
    package's default computes (stock float32 blocks there; K2's plain
    version and the stock MLP here); ``fused_mlp=True`` is visibly apart,
    K3's plain version rounding t, h_pre and h to bf16."""
    x = np.random.default_rng(10).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    fm = _flax(False, True)
    params = _params(fm, x, seed=11)
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    default, fused = _port(False, True), _port(False, True, fused_mlp=True)
    for m in (default, fused):
        load_flax_params(m, params)
    with torch.no_grad():
        got = default(torch.from_numpy(x)).numpy()
        apart = fused(torch.from_numpy(x)).numpy()
    # tolerance: float32 convolutions and products summed in other orders
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert np.abs(apart - ref).max() > 1e-3


def test_padding_valid_drops_the_remainder():
    """``"VALID"`` (torchvision's padding 0): at 72² the stages are 18, 9,
    4 and 2 where ``SAME`` gives 5 and 3; at 64² both agree bit for bit."""
    from vision_collision_detection_tpu_torch.models.video_classifier import (
        init_weights,
    )

    sides = {}

    def hook(name):
        def record(module, args, out):
            sides[name] = sides.get(name, ()) + (out.shape[1],)
        return record

    models = {p: _port(True, True, padding=p) for p in ("SAME", "VALID")}
    init_weights(models["SAME"], torch.Generator().manual_seed(0))
    models["VALID"].load_state_dict(models["SAME"].state_dict())
    for p, m in models.items():
        for stage in range(4):
            getattr(m, f"stage{stage}_block0").register_forward_hook(hook(p))
    for side, want in ((72, {"SAME": (18, 9, 5, 3), "VALID": (18, 9, 4, 2)}),
                       (64, {"SAME": (16, 8, 4, 2), "VALID": (16, 8, 4, 2)})):
        sides.clear()
        x = torch.from_numpy(np.random.default_rng(12).normal(
            size=(1, side, side, 3)).astype(np.float32))
        with torch.no_grad():
            out = {p: m(x) for p, m in models.items()}
        assert sides == want
        assert torch.equal(out["SAME"], out["VALID"]) == (side == 64)
    with pytest.raises(ValueError, match="padding"):
        _port(True, True, padding="same")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["convnext_base", "convnext_large"])
def test_base_and_large_widths_match_flax(name, dtype):
    """The real widths of convnext base (128–1024) and large (192–1536),
    depths cut to one block a stage, at 32² (stages of 8, 4, 2, 1): float32
    on the default switches (K2's plain version, the stock MLP) against
    flax's default; bf16 on K2's and K3's plain versions against flax's
    stock bf16 blocks, where K3 rounds as flax's bf16 chain does."""
    from vision_collision_detection_tpu.models.backbones import (
        convnext as flax_convnext,
    )

    dims = convnext.convnext_base().dims if name == "convnext_base" else \
        convnext.convnext_large().dims
    x = np.random.default_rng(13).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    fm = flax_convnext.ConvNeXt(depths=DEPTHS, dims=dims, dtype=jdt)
    params = _params(fm, x, seed=14)
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    tm = convnext.ConvNeXt(DEPTHS, dims, dtype=tdt).eval()
    assert all(b.use_fused_mlp == (dtype == "bfloat16") and
               b.use_dwconv_kernel for b in _blocks(tm))
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, dims[-1]) and np.isfinite(got).all()
    if dtype == "float32":
        # tolerance: float32 convolutions and products summed in other orders
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        # tolerance: the bf16 roundings of 4 blocks in other places and sum
        # orders, head-normed (the kernel path's bound above; measured
        # 4.0e-2 largest and 8.5e-3 mean on features up to 4.6)
        np.testing.assert_allclose(got, ref, rtol=0, atol=0.1)
        assert float(np.abs(got - ref).mean()) < 0.02
