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
    """Both switches on: K2's plain version is float32-exact, K3's rounds t,
    h_pre and h to bf16 as the kernel does."""
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    params = _params(_flax(True, True), x, seed=3)
    stock, fused = _port(True, True, dwconv_kernel=False, fused_mlp=False), \
        _port(True, True)
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
    switches = {} if kernels else dict(dwconv_kernel=False, fused_mlp=False)
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
