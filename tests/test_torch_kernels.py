"""The port's kernel modules on the CPU, where each wrapper takes its plain
PyTorch version, held against the JAX package's Pallas kernels run in
interpret mode (K1, K2, K3) on the same numpy inputs.

The CUDA kernels themselves run only on a card: ``python3 chip_smoke.py``
holds each against its plain version there at the flagship shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import bf16_ulp
from vision_collision_detection_tpu.ops.convnext_mlp_pallas import (
    convnext_mlp_block,
)
from vision_collision_detection_tpu.ops.dwconv_pallas import (
    dwconv7x7 as jax_dwconv7x7,
)
from vision_collision_detection_tpu.ops.pallas_ops import (
    fused_dequant_normalize_pad,
)
from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
from vision_collision_detection_tpu_torch.ops import dequant_pad as k1
from vision_collision_detection_tpu_torch.ops import dwconv as k2

MEAN = (0.45, 0.45, 0.45)
STD = (0.225, 0.225, 0.225)


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("content", [(126, 224), (224, 168), (125, 223)])
def test_k1_plain_matches_pallas(content):
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (2, *content, 3), dtype=np.uint8)
    ref = np.asarray(fused_dequant_normalize_pad(
        jnp.asarray(u8), 224, MEAN, STD, interpret=True)).astype(np.float32)
    got = _np(k1.dequant_normalize_pad_plain(torch.from_numpy(u8), 224,
                                             MEAN, STD))
    assert got.shape == ref.shape == (2, 224, 224, 3)
    # tolerance: at most 1 bf16 ulp (both round x·a + b to bf16 once)
    assert np.all(np.abs(got - ref) <= bf16_ulp(ref))


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_k1_plain_matches_pallas_with_side_bars(out_dtype):
    """Content 120×213 into 224²: bars on all four sides, an odd content
    width (rows of 639 bytes, off any 16-byte boundary), in both output
    dtypes, against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(8)
    u8 = rng.integers(0, 256, (2, 120, 213, 3), dtype=np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    ref = np.asarray(fused_dequant_normalize_pad(
        jnp.asarray(u8), 224, mean, std, out_dtype=getattr(jnp, out_dtype),
        interpret=True)).astype(np.float32)
    got = _np(k1.dequant_normalize_pad_plain(
        torch.from_numpy(u8), 224, mean, std, getattr(torch, out_dtype)))
    assert got.shape == ref.shape == (2, 224, 224, 3)
    # the bars: rows 0..51 and 172.., columns 0..4 and 218..
    assert np.array_equal(got[:, :52], ref[:, :52])
    assert np.array_equal(got[:, 172:], ref[:, 172:])
    assert np.array_equal(got[:, :, :5], ref[:, :, :5])
    assert np.array_equal(got[:, :, 218:], ref[:, :, 218:])
    if out_dtype == "bfloat16":
        # tolerance: at most 1 bf16 ulp (both round x·a + b to bf16 once)
        assert np.all(np.abs(got - ref) <= bf16_ulp(ref))
    else:
        # tolerance: the same float32 formula; XLA may fuse x·a + b into one
        # rounding, 1 float32 ulp at |y| < 4 is 4.8e-7
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-7)


def test_k1_wrapper_on_cpu_takes_plain_version():
    u8 = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (3, 18, 32, 3), dtype=np.uint8))
    before = k1.dequant_normalize_pad.launches
    out = k1.dequant_normalize_pad(u8, 32, MEAN, STD)
    assert k1.dequant_normalize_pad.launches == before
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    assert torch.equal(out, k1.dequant_normalize_pad_plain(u8, 32, MEAN, STD))
    # bars hold the normalised black −mean/std
    bar = torch.tensor(-0.45 / 0.225, dtype=torch.bfloat16)
    assert torch.all(out[:, :7] == bar) and torch.all(out[:, 25:] == bar)


def test_k1_plain_float32_matches_pallas():
    u8 = np.random.default_rng(4).integers(0, 256, (2, 126, 224, 3),
                                           dtype=np.uint8)
    ref = np.asarray(fused_dequant_normalize_pad(
        jnp.asarray(u8), 224, MEAN, STD, out_dtype=jnp.float32,
        interpret=True))
    got = k1.dequant_normalize_pad(torch.from_numpy(u8), 224, MEAN, STD,
                                   torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 224, 224, 3)
    # tolerance: the same float32 formula; XLA may fuse x·a + b into one
    # rounding, 1 float32 ulp at |y| < 4 is 4.8e-7
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=5e-7)


def test_k1_kernel_path_rejects_an_out_dtype_it_does_not_write():
    # a tensor off the CPU takes the kernel path, which checks before launch
    u8 = torch.empty(2, 18, 32, 3, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="bf16 or float32"):
        k1.dequant_normalize_pad(u8, 32, MEAN, STD, torch.float16)


@pytest.mark.parametrize("use_kernel", ["force", "never"])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_eval_preprocess_matches_jax(use_kernel, out_dtype):
    from vision_collision_detection_tpu.config import AugmentConfig as JaxAug
    from vision_collision_detection_tpu.ops.preprocess import (
        eval_preprocess as jax_eval_preprocess,
    )
    from vision_collision_detection_tpu_torch.config import AugmentConfig
    from vision_collision_detection_tpu_torch.ops.preprocess import (
        eval_preprocess,
    )

    u8 = np.random.default_rng(5).integers(0, 256, (2, 3, 18, 32, 3),
                                           dtype=np.uint8)
    ref = np.asarray(jax_eval_preprocess(
        jnp.asarray(u8), JaxAug(), 32, getattr(jnp, out_dtype),
        use_pallas=use_kernel)).astype(np.float32)
    got = eval_preprocess(torch.from_numpy(u8), AugmentConfig(), 32,
                          getattr(torch, out_dtype), use_kernel=use_kernel)
    assert got.dtype == getattr(torch, out_dtype)
    assert got.shape == ref.shape == (2, 3, 32, 32, 3)
    # tolerance: the same formula in float32 on both sides (the resize of
    # content that is already S wide keeps it), then one rounding to the
    # output dtype: 1 bf16 ulp, or 1e-6 in float32
    if out_dtype == "bfloat16":
        assert np.all(np.abs(_np(got) - ref) <= bf16_ulp(ref))
    else:
        np.testing.assert_allclose(_np(got), ref, rtol=0, atol=1e-6)


def test_k1_rejects_oversized_content():
    with pytest.raises(ValueError):
        k1.dequant_normalize_pad(torch.zeros(1, 40, 32, 3, dtype=torch.uint8),
                                 32, MEAN, STD)


@pytest.mark.parametrize("shape", [(2, 9, 10, 16), (1, 7, 7, 32)])
def test_k2_plain_matches_pallas(shape):
    rng = np.random.default_rng(2)
    C = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(0, 1 / 7, (7, 7, C)).astype(np.float32)
    b = rng.normal(0, 0.1, C).astype(np.float32)
    ref = np.asarray(jax_dwconv7x7(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b)))
    got = _np(k2.dwconv7x7(torch.from_numpy(x),
                           torch.from_numpy(w.reshape(49, C)),
                           torch.from_numpy(b)))
    # tolerance: float32 sums of 49 taps in another order
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_k2_rejects_bad_weight_shape():
    x = torch.zeros(1, 8, 8, 16)
    with pytest.raises(ValueError):
        k2.dwconv7x7(x, torch.zeros(7, 7, 16), torch.zeros(16))


def _k3_inputs(C, rng):
    x = rng.normal(size=(2, 5, 6, C)).astype(np.float32)
    y = rng.normal(size=(2, 5, 6, C)).astype(np.float32)
    params = dict(
        ln_w=1 + 0.1 * rng.normal(size=C), ln_b=0.1 * rng.normal(size=C),
        w1=rng.normal(0, C ** -0.5, (C, 4 * C)),
        b1=0.1 * rng.normal(size=4 * C),
        w2=rng.normal(0, (4 * C) ** -0.5, (4 * C, C)),
        b2=0.1 * rng.normal(size=C), gamma=rng.uniform(0.5, 1.5, C))
    return x, y, {k: v.astype(np.float32) for k, v in params.items()}


@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("C", [16, 32])
def test_k3_plain_matches_pallas(C, approximate):
    rng = np.random.default_rng(3 + C)
    x, y, p = _k3_inputs(C, rng)
    xb, yb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    ref = np.asarray(convnext_mlp_block(
        xb, yb, *(jnp.asarray(p[k]) for k in
                  ("ln_w", "ln_b", "w1", "b1", "w2", "b2", "gamma")),
        approximate)).astype(np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    ty = torch.from_numpy(y).to(torch.bfloat16)
    got = k3.convnext_mlp(tx, ty, approximate=approximate,
                          **{k: torch.from_numpy(v) for k, v in p.items()})
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    # tolerance, bf16-level: 2 bf16 ulps of each output, plus 2 ulps of the
    # largest output for the rare h_pre rounding flip between the two
    # packages' GELU (the JAX one evaluates in bf16)
    got = _np(got)
    bound = 2 * bf16_ulp(ref) + 2 * bf16_ulp(np.abs(ref).max())
    assert np.all(np.abs(got - ref) <= bound), np.abs(got - ref).max()


def test_k3_plain_float32_residual_dtype():
    rng = np.random.default_rng(9)
    x, y, p = _k3_inputs(16, rng)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    out = k3.convnext_mlp(torch.from_numpy(x), torch.from_numpy(y),
                          approximate=True, **tp)
    assert out.dtype == torch.float32
    with pytest.raises(ValueError):
        k3.convnext_mlp(torch.from_numpy(x), torch.from_numpy(y),
                        approximate=True, **dict(tp, w1=tp["w2"]))
