"""The port's training preprocessing (color ops, affine warps, blur, cutout,
``augment_clip``, ``train_preprocess``) against the JAX package on the same
numpy frames. The two packages' generators give different draws, so each
comparison samples the clips' parameters with the JAX
``sample_clip_params`` and hands the same values to both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_collision_detection_tpu.config import AugmentConfig as JaxAug
from vision_collision_detection_tpu.ops import affine as jax_affine
from vision_collision_detection_tpu.ops import augment as jax_augment
from vision_collision_detection_tpu.ops import color as jax_color
from vision_collision_detection_tpu.ops.preprocess import (
    train_preprocess as jax_train_preprocess,
)
from vision_collision_detection_tpu_torch.config import AugmentConfig
from vision_collision_detection_tpu_torch.ops import affine, augment, color
from vision_collision_detection_tpu_torch.ops.preprocess import (
    make_train_preprocess,
    train_preprocess,
)

B, T, H, W = 4, 3, 16, 20


def _frames(seed, shape=(B, T, H, W, 3)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("op,arg", [
    ("adjust_brightness", 1.3), ("adjust_contrast", 0.7),
    ("adjust_saturation", 1.4), ("adjust_hue", 0.08), ("adjust_hue", -0.3),
    ("rgb_to_grayscale", None), ("solarize", 0.5), ("posterize", 3),
    ("posterize", 6), ("invert", None)])
def test_color_op_matches_jax(op, arg):
    x = _frames(1, (2, 6, 7, 3))
    args = () if arg is None else (arg,)
    ref = np.asarray(getattr(jax_color, op)(jnp.asarray(x), *args))
    got = _np(getattr(color, op)(torch.from_numpy(x), *args))
    assert got.shape == ref.shape
    # tolerance: the same float32 formulas, rounded in other places (the
    # HSV round trip divides); posterize's floor sees identical products
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def _warp_params(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-7, 7, B).astype(np.float32),
            np.stack([rng.uniform(-1.4, 1.4, B), rng.uniform(-1.1, 1.1, B)],
                     -1).astype(np.float32),
            rng.uniform(0.95, 1.1, B).astype(np.float32),
            rng.uniform(-2, 2, B).astype(np.float32))


@pytest.mark.parametrize("mode", ["gather", "separable"])
def test_warps_match_jax(mode):
    x = _frames(2)
    params = _warp_params(3)
    jfn = (jax_affine.affine_warp_clip if mode == "gather"
           else jax_affine.affine_warp_clip_separable)
    ref = np.stack([np.asarray(jfn(jnp.asarray(x[b]),
                                   *(jnp.asarray(p[b]) for p in params)))
                    for b in range(B)])
    tfn = (affine.affine_warp_clip if mode == "gather"
           else affine.affine_warp_clip_separable)
    got = _np(tfn(torch.from_numpy(x), *(torch.from_numpy(p) for p in params)))
    assert got.shape == ref.shape == x.shape
    diff = np.abs(got - ref)
    if mode == "gather":
        # tolerance: float32 coordinates and four-tap blends
        assert diff.max() <= 1e-5, diff.max()
    else:
        # tolerance: the first pass is rounded to bf16 before the second;
        # float32 sums in another order flip that rounding by one bf16 ulp
        # (at most 2^-8 for values under 1) in a few places
        assert diff.max() <= 2 ** -7 and diff.mean() <= 1e-4, (
            diff.max(), diff.mean())


def test_blur_matches_jax():
    x = _frames(4, (T, H, W, 3))
    for sigma in (0.5, 1.0):
        ref = np.asarray(jax_augment.gaussian_blur_clip(jnp.asarray(x), sigma))
        got = _np(augment.gaussian_blur_clip(torch.from_numpy(x), sigma))
        # tolerance: float32 sums of 5 or 9 taps in another order
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


IDENTITY = dict(brightness_range=(1.0, 1.0), contrast_range=(1.0, 1.0),
                saturation_range=(1.0, 1.0), hue_range=(0.0, 0.0),
                rotation_range=(0.0, 0.0), scale_range=(1.0, 1.0),
                shear_range=(0.0, 0.0), translate_range=(0.0, 0.0),
                grayscale_prob=0.0, blur_sigma=0.0, cutout_prob=0.0,
                aug_probability=1.0)
WARP = dict(rotation_range=(-7.0, 7.0), scale_range=(0.95, 1.1),
            shear_range=(-2.0, 2.0), translate_range=(0.0, 0.07))
# Each effect on its own (the rest the identity), then the default recipe
# and the recipe with its skip gate shut. "warp": a bf16-level tolerance.
CASES = {
    "color": (dict(IDENTITY, brightness_range=(0.8, 1.2),
                   contrast_range=(0.8, 1.2), saturation_range=(0.8, 1.2),
                   hue_range=(-0.1, 0.1)), False),
    "separable_warp": (dict(IDENTITY, **WARP), True),
    "gather_warp": (dict(IDENTITY, affine_mode="gather", **WARP), False),
    "grayscale": (dict(IDENTITY, grayscale_prob=1.0), False),
    "blur": (dict(IDENTITY, blur_sigma=0.5), False),
    "posterize": (dict(IDENTITY, posterization_prob=1.0), False),
    "solarize": (dict(IDENTITY, solarization_prob=1.0), False),
    "invert": (dict(IDENTITY, color_inversion_prob=1.0), False),
    "cutout": (dict(IDENTITY, cutout_prob=1.0, cutout_count_range=(1, 3)),
               False),
    "default": ({}, True),
    "skip_gate": (dict(aug_probability=0.0), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_augment_clip_matches_jax_on_jax_params(case):
    fields, warped = CASES[case]
    jcfg, tcfg = JaxAug(**fields), AugmentConfig(**fields)
    x = _frames(5)
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    params = jax.vmap(lambda k: jax_augment.sample_clip_params(
        k, jcfg, H, W))(keys)
    ref = np.asarray(jax.vmap(lambda f, p: jax_augment.augment_clip(
        f, p, jcfg))(jnp.asarray(x), params))
    got = np.stack([_np(augment.augment_clip(
        torch.from_numpy(x[b]),
        {k: torch.from_numpy(np.array(v[b])) for k, v in params.items()
         if k != "noise_key"}, tcfg)) for b in range(B)])
    assert got.shape == ref.shape == x.shape
    diff = np.abs(got - ref)
    if warped:
        # tolerance: as test_warps_match_jax's separable warp
        assert diff.max() <= 2 ** -7 and diff.mean() <= 1e-4, (
            diff.max(), diff.mean())
    else:
        # tolerance: float32 elementwise work rounded in other places
        assert diff.max() <= 2e-6, diff.max()
    if case == "skip_gate":
        np.testing.assert_array_equal(got, x)
    if case == "cutout":
        assert (got == 0).any()


def test_sample_clip_params_laws_and_determinism():
    cfg = AugmentConfig(grayscale_prob=0.5, cutout_prob=0.5,
                        cutout_count_range=(1, 3))
    n = 4096
    g = torch.Generator().manual_seed(0)
    p = augment.sample_clip_params(g, cfg, 100, 200, batch=n)
    for name, (lo, hi) in (("brightness", cfg.brightness_range),
                           ("hue", cfg.hue_range),
                           ("rotation", cfg.rotation_range),
                           ("scale", cfg.scale_range)):
        v = p[name].numpy()
        assert v.shape == (n,) and lo <= v.min() and v.max() <= hi, name
    tx = p["translate"][:, 0].numpy()
    assert p["translate"].shape == (n, 2) and np.abs(tx).max() <= 0.07 * 200
    assert (tx < 0).any() and (tx > 0).any()
    # the gates' rates, each from its own draws (binomial sd at n=4096 is
    # under 0.008: 0.05 is more than six of them)
    assert abs(float(p["skip"].float().mean()) - 0.1) < 0.05
    assert abs(float(p["grayscale"].float().mean()) - 0.5) < 0.05
    agree = float((p["grayscale"] == p["cutout"]).float().mean())
    assert 0.45 < agree < 0.55
    assert set(p["cutout_count"].tolist()) == {1, 2, 3}
    assert p["cutout_top"].shape == (n, 3)
    assert int((p["cutout_top"] + p["cutout_h"]).max()) <= 100
    again = augment.sample_clip_params(torch.Generator().manual_seed(0), cfg,
                                       100, 200, batch=n)
    assert all(torch.equal(p[k], again[k]) for k in p)


@pytest.mark.parametrize("flip_prob", [0.0, 1.0])
@pytest.mark.parametrize("content", [(18, 32), (18, 28)])
def test_train_preprocess_flip_only_matches_jax(content, flip_prob):
    """Augmentation off: letterbox, flip (on the uint8 tensor when the
    content is already S wide, after the letterbox otherwise), normalise.
    A flip probability of 0 or 1 makes the draw the same in both."""
    fields = dict(enabled=False, horizontal_flip_prob=flip_prob)
    u8 = np.random.default_rng(6).integers(0, 256, (2, 3, *content, 3),
                                           dtype=np.uint8)
    for out_dtype in ("float32", "bfloat16"):
        ref = np.asarray(jax_train_preprocess(
            jax.random.PRNGKey(0), jnp.asarray(u8), JaxAug(**fields), 32,
            getattr(jnp, out_dtype))).astype(np.float32)
        got = train_preprocess(torch.Generator().manual_seed(0),
                               torch.from_numpy(u8), AugmentConfig(**fields),
                               32, getattr(torch, out_dtype))
        assert got.dtype == getattr(torch, out_dtype)
        assert got.shape == ref.shape == (2, 3, 32, 32, 3)
        # tolerance: the same float32 resize and formula, one rounding to
        # the output dtype (1 bf16 ulp of 2.3, the largest |value|)
        atol = 1e-5 if out_dtype == "float32" else 2 ** -6
        np.testing.assert_allclose(_np(got), ref, rtol=0, atol=atol)


def test_train_preprocess_draws_from_the_generator():
    cfg = AugmentConfig(aug_probability=1.0, cutout_prob=1.0)
    fn = make_train_preprocess(cfg, 32, torch.float32)
    u8 = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (3, 2, 18, 32, 3), dtype=np.uint8))
    a = fn(torch.Generator().manual_seed(1), u8)
    b = fn(torch.Generator().manual_seed(1), u8)
    c = fn(torch.Generator().manual_seed(2), u8)
    assert a.shape == (3, 2, 32, 32, 3) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    # one clip's frames share its parameters: a static clip stays static
    static = u8[:, :1].expand(-1, 2, -1, -1, -1).contiguous()
    s = fn(torch.Generator().manual_seed(3), static)
    assert torch.equal(s[:, 0], s[:, 1])


def test_augment_config_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(AugmentConfig)]
            == [f.name for f in dataclasses.fields(JaxAug)])
