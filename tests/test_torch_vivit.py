"""The ViViT path of the port against the JAX package on the CPU: one
``TransformerBlock``, the whole model for both attention impls in float32
and bf16, the weight bridge, ``remat``, one training step against
``jax.value_and_grad`` with the optax update, and the predictor's
probabilities. Tiny sizes: vivit_tiny at 28² with patch 14 and
vivit_small's widths at 16² with patch 8 (4 tokens per frame), B·T ≤ 4.

On the CPU the JAX ``"flash"`` blocks take their einsum branch (its tests'
way) and the port's take K4's plain version; the CUDA kernels are held
against that plain version by ``python3 chip_smoke.py`` on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import bf16_ulp, randomize_params
from vision_collision_detection_tpu.config import ExperimentConfig as JaxConfig
from vision_collision_detection_tpu.infer.predictor import (
    CollisionPredictor as JaxPredictor,
)
from vision_collision_detection_tpu.models import build_model as jax_build
from vision_collision_detection_tpu.models.vivit import (
    TransformerBlock as JaxBlock,
)
from vision_collision_detection_tpu.ops.preprocess import (
    train_preprocess as jax_train_preprocess,
)
from vision_collision_detection_tpu.train import optim as jax_optim
from vision_collision_detection_tpu.train.steps import (
    weighted_loss as jax_weighted_loss,
)
from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.infer.predictor import (
    CollisionPredictor,
)
from vision_collision_detection_tpu_torch.models import build_model
from vision_collision_detection_tpu_torch.models.backbones import feature_dim
from vision_collision_detection_tpu_torch.models.convert import (
    from_flax_params,
)
from vision_collision_detection_tpu_torch.models.vivit import (
    TransformerBlock,
    ViViT,
    build_vivit,
)
from vision_collision_detection_tpu_torch.ops import flash_attention as fa
from vision_collision_detection_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_train_step,
)

# name → (overrides, frame side): 4 tokens per frame in both
MODELS = {
    "tiny": ({"model.backbone": "vivit_tiny", "model.patch_size": 14}, 28),
    "small": ({"model.backbone": "vivit_small", "model.patch_size": 8}, 16),
}
T = 2


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _overrides(size, impl, dtype, **more):
    ov, side = MODELS[size]
    return dict(ov, **{"model.attention_impl": impl, "model.dtype": dtype,
                       "model.temporal_mode": "attention",
                       "data.frame_size": side, "data.fps": 1,
                       "data.duration": T}, **more), side


def _flax_params(overrides, side, seed, head_scale=3.0):
    """``head_scale`` spreads the logits away from uniform."""
    model = jax_build(JaxConfig().override(overrides).model)
    init = jax.jit(lambda k, x: model.init(k, x))(
        jax.random.PRNGKey(0), jnp.zeros((1, T, side, side, 3), jnp.float32))
    params = randomize_params(jax.device_get(init["params"]),
                              np.random.default_rng(seed))
    params["head"]["kernel"] *= head_scale
    return model, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_transformer_block_matches_jax(impl, dtype):
    dim, heads, seq = 64, 4, 9
    jblock = JaxBlock(dim=dim, num_heads=heads, dtype=getattr(jnp, dtype),
                      attention_impl=impl)
    x = np.random.default_rng(5).normal(size=(3, seq, dim)).astype(np.float32)
    params = randomize_params(jax.device_get(jblock.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]),
        np.random.default_rng(6))
    td = getattr(torch, dtype)
    ref = np.asarray(jblock.apply({"params": params}, jnp.asarray(x).astype(
        getattr(jnp, dtype))), np.float32)
    block = TransformerBlock(dim, heads, dtype=td, attention_impl=impl).eval()
    block.load_state_dict(from_flax_params(params), strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x).to(td))
    assert got.dtype == td
    if dtype == "float32":
        # tolerance: float32 sums in another order through two LayerNorms,
        # six projections and the attention, on outputs of order 1
        np.testing.assert_allclose(_np(got), ref, rtol=5e-5, atol=5e-5)
    else:
        # tolerance: each bf16 rounding inside (LayerNorm output, q, k, v,
        # logits and softmax for "xla", p, the MLP's hidden layer) can flip
        # by an ulp between the frameworks and the projections sum 64 to
        # 256 such values: 4 bf16 ulps of the largest output
        assert np.abs(_np(got) - ref).max() <= 4 * bf16_ulp(np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("size", list(MODELS))
def test_vivit_matches_jax(size, impl, dtype):
    overrides, side = _overrides(size, impl, dtype)
    jmodel, params = _flax_params(overrides, side, seed=7)
    x = np.random.default_rng(8).normal(size=(2, T, side, side, 3)).astype(
        np.float32)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = build_model(ExperimentConfig().override(overrides).model,
                        device="cpu", frame_size=side)
    assert isinstance(model, ViViT) and not model.training
    model.load_state_dict(from_flax_params(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 3)
    # tolerance, float32: sums in another order through up to 12 blocks, on
    # logits of order 1 to 4. bf16: 1-ulp flips of the activations through
    # the blocks (2^-8 relative each), then a head scaled by 3 that sums 64
    # or 384 of them: 0.15 on logits that span ±4, under 2% of their range
    tol = 2e-4 if dtype == "float32" else 0.15
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))


def test_the_two_impls_share_one_tree_and_agree_to_bf16_resolution():
    ov_x, side = _overrides("tiny", "xla", "bfloat16")
    ov_f, _ = _overrides("tiny", "flash", "bfloat16")
    _, params = _flax_params(ov_x, side, seed=9)
    sd = from_flax_params(params)
    x = torch.from_numpy(np.random.default_rng(10).normal(
        size=(2, T, side, side, 3)).astype(np.float32))
    outs = []
    for ov in (ov_x, ov_f):
        m = build_model(ExperimentConfig().override(ov).model, device="cpu",
                        frame_size=side)
        m.load_state_dict(sd, strict=True)
        with torch.no_grad():
            outs.append(m(x))
    assert not torch.equal(*outs)  # the softmax runs in another dtype
    # the JAX package's own bound between its impls (tests/test_flash_attention.py)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=5e-2,
                               rtol=2e-2)


def test_bridge_round_trips_every_parameter():
    overrides, side = _overrides("tiny", "flash", "float32")
    _, params = _flax_params(overrides, side, seed=11)
    model = build_model(ExperimentConfig().override(overrides).model,
                        device="cpu", frame_size=side)
    sd = from_flax_params(params)
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd, strict=True)
    H, D = 4, 16

    def back(path, leaf, t):
        """The torch tensor as the flax leaf it came from."""
        name, kind = (["", *path])[-2], path[-1]
        if kind in ("spatial_pos", "temporal_pos", "scale", "bias"):
            return t.reshape(leaf.shape)
        if name in ("query", "key", "value"):
            return t.t().reshape(-1, H, D)
        if name == "out":
            return t.t().reshape(H, D, -1)
        if name == "patch_embed":
            return t.permute(2, 3, 1, 0)
        return t.t()

    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    seen = set()
    for path, leaf in flat:
        path = [p.key for p in path]
        kind = path[-1]
        key = ".".join(path if kind.endswith("_pos") else path[:-1] + [
            "weight" if kind in ("kernel", "scale") else "bias"])
        seen.add(key)
        assert np.array_equal(back(path, leaf, sd[key]).numpy(), leaf), key
    assert seen == set(sd)
    assert sd["temporal_pos"].shape == (64, 64)  # the whole table of max_frames


def test_scaled_config_builds_a_576_token_model():
    cfg = ExperimentConfig().override({
        "model.backbone": "vivit_small", "model.temporal_mode": "attention",
        "model.patch_size": 14, "data.fps": 8, "data.duration": 4,
        "data.frame_size": 336, "augment.blur_sigma": 0.0,
        "model.attention_impl": "flash"})
    assert cfg.model.image_size == 224  # the position table follows the data
    model, _ = create_train_state(cfg, torch.Generator().manual_seed(0), 10,
                                  device="cpu")
    pred = CollisionPredictor(cfg, model.state_dict(), device="cpu")
    for m in (model, pred.model):
        assert m.spatial_pos.shape == (576, 384)
        assert m.spatial_layers == 8 and m.temporal_layers == 4
        assert m.spatial_0.attn.num_heads == 6 and m.spatial_0.attn.head_dim == 64
        assert m.spatial_0.attention_impl == "flash"
        assert m.temporal_0.attention_impl == "xla"
    # the position tables' law: N(0, 0.02²), as flax's normal(0.02)
    assert float(model.spatial_pos.detach().std()) == pytest.approx(0.02, rel=0.05)
    assert float(model.temporal_pos.detach().std()) == pytest.approx(0.02, rel=0.05)
    assert [feature_dim(f"vivit_{s}") for s in ("tiny", "small", "base")] == [
        64, 384, 768]
    with torch.device("meta"):  # shapes only: vivit_base has 110 M weights
        base = build_vivit(cfg.override({"model.backbone": "vivit_base"}).model,
                           frame_size=336)
    assert base.spatial_pos.shape == (576, 768) and base.spatial_layers == 12
    assert base.spatial_0.attn.num_heads == 12
    assert base.spatial_0.attn.head_dim == 64
    with pytest.raises(ValueError, match="patches"):
        model(torch.zeros(1, 2, 224, 224, 3))
    with pytest.raises(ValueError, match="divisible"):
        build_model(cfg.model, device="cpu", frame_size=100)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tiny_config_builds_a_256_token_model(dtype):
    """``chip_smoke.py`` phase 27's configuration: phase 9's with vivit_tiny
    and 224² frames builds 256 tokens a frame, 2 spatial blocks of 4 heads
    of 16 on K4 and 1 temporal block, whose K4 calls take the head_dim-16
    Hopper routes on the card."""
    cfg = ExperimentConfig().override({
        "model.backbone": "vivit_tiny", "model.temporal_mode": "attention",
        "model.patch_size": 14, "data.fps": 8, "data.duration": 4,
        "data.frame_size": 224, "augment.blur_sigma": 0.0,
        "model.attention_impl": "flash", "model.dtype": dtype})
    assert cfg.data.num_frames == 32
    model, _ = create_train_state(cfg, torch.Generator().manual_seed(0), 10,
                                  device="cpu")
    pred = CollisionPredictor(cfg, model.state_dict(), device="cpu")
    for m in (model, pred.model):
        assert m.spatial_pos.shape == (256, 64)
        assert m.spatial_layers == 2 and m.temporal_layers == 1
        assert m.spatial_0.attn.num_heads == 4
        assert m.spatial_0.attn.head_dim == 16
        assert m.spatial_0.attention_impl == "flash"
        assert m.temporal_0.attention_impl == "xla"
        assert m.spatial_0.attn.dtype == getattr(torch, dtype)
    want = "wgmma_d16" if dtype == "bfloat16" else "f32_wgmma_d16"
    assert fa.route(getattr(torch, dtype), 16) == want
    assert pred._fold_stride() == 1


def test_flash_with_dropout_raises_and_xla_draws_from_the_generator():
    block = TransformerBlock(32, 4, dropout=0.1, attention_impl="flash")
    with pytest.raises(ValueError, match="dropout"):
        block(torch.zeros(1, 8, 32))
    with pytest.raises(ValueError, match="attention_impl"):
        TransformerBlock(32, 4, attention_impl="sdpa")
    block = TransformerBlock(32, 4, dropout=0.5, dtype=torch.float32).train()
    x = torch.randn(2, 8, 32)
    with torch.no_grad():
        with pytest.raises(ValueError, match="generator"):
            block(x)
        a = block(x, torch.Generator().manual_seed(1))
        b = block(x, torch.Generator().manual_seed(1))
        c = block(x, torch.Generator().manual_seed(2))
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert torch.equal(block.eval()(x), block(x))  # eval: nothing dropped


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_remat_changes_nothing(impl):
    overrides, side = _overrides("tiny", impl, "bfloat16")
    cfg = ExperimentConfig().override(overrides)
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(2, T, side, side, 3)).astype(np.float32))
    results = []
    for remat in (False, True):
        model = build_model(cfg.override({"model.remat": remat}).model,
                            device="cpu", frame_size=side).train()
        assert model.remat is remat
        loss = model(x).square().sum()
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in
                                        model.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys() and all(g is not None for g in g1.values())
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


# ---- one training step -----------------------------------------------------

CLASS_WEIGHTS = np.array([1.0, 2.0, 0.5], np.float32)
# impl, dtype → tolerances (loss and grad norm relative; each parameter's
# gradient error relative to that gradient's norm; each parameter after the
# update, the mean absolute difference). float32 holds the step tightly.
# bf16: the activations'
# 1-ulp flips between the frameworks reach each gradient as a few 2^-8 of
# its norm, most on the temporal blocks' query and key, whose softmax over
# two frames passes little gradient; AdamW's first step moves every weight
# by about the rate 3e-4 whatever the gradient's size, so a flipped sign of
# a near-zero gradient shows as twice the rate; the mean difference over a
# parameter reads 1e-8 in float32 and 3e-6 in bf16, the limits are ten
# times that.
STEP_CASES = {"flash-float32": ("flash", "float32", 1e-5, 1e-4, 2e-4, 1e-7),
              "xla-float32": ("xla", "float32", 1e-5, 1e-4, 2e-4, 1e-7),
              "flash-bfloat16": ("flash", "bfloat16", 5e-2, 5e-2, 0.2, 3e-5),
              "xla-bfloat16": ("xla", "bfloat16", 5e-2, 5e-2, 0.2, 3e-5)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_training_step_matches_jax(case):
    impl, dtype, loss_tol, norm_tol, grad_tol, param_tol = STEP_CASES[case]
    overrides, side = _overrides(
        "tiny", impl, dtype, **{"augment.enabled": False,
                                "augment.horizontal_flip_prob": 0.0})
    jcfg = JaxConfig().override(overrides)
    # the head at its own scale: a spread head turns the activations' bf16
    # flips into loss differences of several percent
    jmodel, params = _flax_params(overrides, side, seed=13, head_scale=1.0)
    content = (side * 9 // 16, side)  # 15 rows: an odd letterbox pad
    frames = np.random.default_rng(14).integers(
        0, 256, (2, T, *content, 3), dtype=np.uint8)
    targets, mask = np.array([1, 2]), np.ones(2, np.float32)
    x = jax_train_preprocess(jax.random.PRNGKey(0), jnp.asarray(frames),
                             jcfg.augment, side, jnp.dtype(dtype))

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, x, train=True)
        return jax_weighted_loss(logits, jnp.asarray(targets),
                                 jnp.asarray(CLASS_WEIGHTS),
                                 jnp.asarray(mask))[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx, _ = jax_optim.build_optimizer(jcfg.optim, steps_per_epoch=10)
    updates, _ = tx.update(ref_grads, tx.init(params), params)
    ref_params = from_flax_params(jax.device_get(
        optax.apply_updates(params, updates)))
    want = from_flax_params(jax.device_get(ref_grads))

    cfg = ExperimentConfig().override(overrides)
    model, state = create_train_state(cfg, torch.Generator().manual_seed(0),
                                      steps_per_epoch=10, device="cpu")
    model.load_state_dict(from_flax_params(params), strict=True)
    step = make_train_step(model, cfg, class_weights=CLASS_WEIGHTS)
    launches = (fa.flash_mha.launches, fa.flash_mha_bwd_dkv.launches,
                fa.flash_mha_bwd_dq.launches)
    state, metrics = step(state, frames, targets, mask,
                          torch.Generator().manual_seed(0))
    # on the CPU K4's Function runs its plain versions: nothing launched
    assert launches == (fa.flash_mha.launches, fa.flash_mha_bwd_dkv.launches,
                        fa.flash_mha_bwd_dq.launches)
    assert state.step == 1 and model.training
    assert float(metrics["loss"]) == pytest.approx(float(ref_loss),
                                                   rel=loss_tol)
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(optax.global_norm(ref_grads)), rel=norm_tol)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    worst = {}
    for name, g in got.items():
        w = want[name]
        assert g is not None and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        # a key bias shifts every logit of a query alike, which the softmax
        # does not see: its true gradient is 0 and what arrives is rounding
        # noise, held against the query bias's gradient beside it
        scale = want[name.replace(".key.bias", ".query.bias")].norm()
        worst[name] = float((g - w).norm() / scale.clamp_min(1e-12))
    assert max(worst.values()) <= grad_tol, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]
    # every attention projection of every spatial block gets a gradient
    attn = [n for n in got if n.startswith("spatial_") and ".attn." in n]
    assert len(attn) == 2 * 4 * 2
    assert all(float(got[n].abs().max()) > 0 for n in attn)
    after = model.state_dict()
    rate = cfg.optim.learning_rate
    means = {}
    for name, w in ref_params.items():
        diff = (after[name] - w).abs()
        # AdamW's first step is rate·g/(|g| + ε): at most the rate either
        # way, and all of it for a gradient as small as ε or for a key
        # bias's rounding noise, whatever its sign. So: no element further
        # than two steps, and the mean over a parameter within param_tol
        assert float(diff.max()) <= 2.1 * rate, name
        if not name.endswith(".key.bias"):
            means[name] = float(diff.mean())
    assert max(means.values()) <= param_tol, sorted(
        means.items(), key=lambda kv: -kv[1])[:3]
    out = make_eval_step(model, cfg)(frames, targets, mask)
    assert not model.training and out["probs"].shape == (2, 3)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_predictor_matches_jax_predictor(impl, dtype):
    overrides, side = _overrides("tiny", impl, dtype)
    _, params = _flax_params(overrides, side, seed=15)
    jpred = JaxPredictor(JaxConfig().override(overrides), params)
    tpred = CollisionPredictor(ExperimentConfig().override(overrides),
                               from_flax_params(params), device="cpu")
    content = (side * 9 // 16, side)  # 15 rows: an odd letterbox pad
    frames = np.random.default_rng(16).integers(
        0, 256, (2, T, *content, 3), dtype=np.uint8)
    ref = np.asarray(jpred._make_forward(False)(frames))
    got = tpred._make_forward(False)(frames).numpy()
    assert got.shape == ref.shape == (2, 3)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    # tolerance: bf16 activations through three blocks, the two frameworks
    # rounding at other places, a head scaled by 3: probabilities to 2e-2;
    # float32: sums in another order, probabilities to 1e-5
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    # a ViViT never subsamples, so the decoder may not fold frames away for
    # it. The JAX predictor's _fold_stride answers by frame_subsample for
    # every backbone, which would hand this model half its frames; the port
    # answers 1 and both forwards are the same function.
    long_clip = {"data.fps": 4, "data.duration": 4}
    assert JaxPredictor(JaxConfig().override(dict(overrides, **long_clip)),
                        params)._fold_stride() == 2
    assert CollisionPredictor(
        ExperimentConfig().override(dict(overrides, **long_clip)), None,
        device="cpu")._fold_stride() == 1
    np.testing.assert_array_equal(tpred._make_forward(True)(frames).numpy(),
                                  got)
