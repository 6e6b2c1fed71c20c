"""The port's training slice against the JAX package: the schedule, the
optimizers given the same gradients, clipping, ``weighted_loss``, and one
whole training step of convnext_tiny + bi-GRU on bridged weights with the
JAX Pallas kernels on (interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import randomize_params
from vision_collision_detection_tpu.config import ExperimentConfig as JaxConfig
from vision_collision_detection_tpu.config import OptimConfig as JaxOptim
from vision_collision_detection_tpu.models import build_model as jax_build
from vision_collision_detection_tpu.ops import convnext_mlp_pallas, dwconv_pallas
from vision_collision_detection_tpu.ops.preprocess import (
    train_preprocess as jax_train_preprocess,
)
from vision_collision_detection_tpu.train import optim as jax_optim
from vision_collision_detection_tpu.train.steps import (
    weighted_loss as jax_weighted_loss,
)
from vision_collision_detection_tpu_torch.config import (
    ExperimentConfig,
    OptimConfig,
)
from vision_collision_detection_tpu_torch.models import build_model
from vision_collision_detection_tpu_torch.models.convert import (
    from_flax_params,
)
from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
from vision_collision_detection_tpu_torch.ops import dwconv as k2
from vision_collision_detection_tpu_torch.train import (
    TrainState,
    build_optimizer,
    clip_by_global_norm_,
    cosine_annealing_schedule,
    create_train_state,
    global_norm,
    make_eval_step,
    make_train_step,
    weighted_loss,
)
from vision_collision_detection_tpu_torch.utils import rng as port_rng


@pytest.mark.parametrize("warmup", [0, 7])
def test_schedule_matches_jax_per_step(warmup):
    args = (3e-4, 5, 4, 0.01, warmup)
    ref = jax_optim.cosine_annealing_schedule(*args)
    got = cosine_annealing_schedule(*args)
    for step in range(0, 60):
        # tolerance: the JAX schedule evaluates in float32, whose cos of
        # π·epoch/T_max (up to ≈ 9 here) is off by ≈ 1e-7 of the base rate
        # near the cosine's minimum
        assert got(step) == pytest.approx(float(ref(step)), rel=1e-6,
                                          abs=1e-6 * args[0]), step
    if warmup:  # linear warmup up to the base rate
        assert got(0) == pytest.approx(args[0] / warmup)
        assert got(warmup - 1) == pytest.approx(args[0])
    else:  # constant within the first epoch (4 steps)
        assert got(3) == got(0) == args[0]


@pytest.mark.parametrize("optimizer", ["adamw", "adam", "sgd"])
def test_optimizer_matches_optax_on_the_same_gradients(optimizer):
    fields = dict(optimizer=optimizer, learning_rate=1e-2, weight_decay=0.05,
                  cosine_t_max_epochs=3, warmup_steps=1)
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in
              shapes.items()} for _ in range(3)]
    tx, _ = jax_optim.build_optimizer(JaxOptim(**fields), steps_per_epoch=1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt, schedule = build_optimizer(OptimConfig(**fields), tp.values(),
                                    steps_per_epoch=1)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in
                                        g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
        for k, p in tp.items():
            # tolerance: the same float32 update rounded in other places,
            # on parameters of order 1
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{k} step {step}")


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(1)
    g = [rng.normal(size=(4, 3)).astype(np.float32),
         rng.normal(size=5).astype(np.float32)]
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(a) for a in g], None)
    tg = [torch.from_numpy(a.copy()) for a in g]
    norm = global_norm(tg)
    assert float(norm) == pytest.approx(float(optax.global_norm(g)), rel=1e-6)
    clip_by_global_norm_(tg, max_norm, norm)
    for t, r in zip(tg, ref):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=0)
    if max_norm > 10:  # under the limit: untouched, not scaled by ‖g‖+ε
        assert all(np.array_equal(t.numpy(), a) for t, a in zip(tg, g))


@pytest.mark.parametrize("loss_type,smoothing", [
    ("cross_entropy", 0.0), ("cross_entropy", 0.1), ("bce", 0.0),
    ("bce", 0.2)])
def test_weighted_loss_matches_jax(loss_type, smoothing):
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (6, 3)).astype(np.float32)
    targets = np.array([0, 1, 2, 2, 1, 0])
    cw = np.array([1.0, 2.5, 0.5], np.float32)
    mask = np.array([1, 1, 0, 1, 1, 0], np.float32)
    ref, ref_per = jax_weighted_loss(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(cw),
        jnp.asarray(mask), loss_type=loss_type, label_smoothing=smoothing)
    got, per = weighted_loss(
        torch.from_numpy(logits), torch.from_numpy(targets),
        torch.from_numpy(cw), torch.from_numpy(mask), loss_type=loss_type,
        label_smoothing=smoothing)
    # tolerance: float32 log-softmax and sums in another order
    assert float(got) == pytest.approx(float(ref), rel=1e-6)
    np.testing.assert_allclose(per.numpy(), np.asarray(ref_per), rtol=1e-6,
                               atol=1e-6)
    # an all-masked batch gives 0, not a division by zero
    zero, _ = weighted_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                            torch.from_numpy(cw), torch.zeros(6),
                            loss_type=loss_type)
    assert float(zero) == 0.0


# ---- one whole training step ----------------------------------------------

S = 32
CONTENT = (18, 32)
OVERRIDES = {"model.backbone": "convnext_tiny", "model.temporal_mode": "gru",
             "model.dtype": "bfloat16", "model.dropout": 0.0,
             "data.frame_size": S, "data.fps": 2, "data.duration": 2,
             "augment.enabled": False, "augment.horizontal_flip_prob": 0.0}
CLASS_WEIGHTS = np.array([1.0, 2.0, 0.5], np.float32)


@pytest.fixture(scope="module")
def step_inputs():
    jcfg = JaxConfig().override(OVERRIDES)
    model = jax_build(jcfg.model)
    init = jax.jit(lambda k, x: model.init(k, x))(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, S, S, 3), jnp.float32))
    params = randomize_params(jax.device_get(init["params"]),
                              np.random.default_rng(8))
    params["fc_out"]["kernel"] *= 10.0  # logits away from uniform
    frames = np.random.default_rng(9).integers(0, 256, (1, 4, *CONTENT, 3),
                                               dtype=np.uint8)
    return params, frames, np.array([1]), np.ones(1, np.float32)


def _jax_loss_and_grads(overrides, params, frames, targets, mask):
    """The JAX ``make_train_step``'s loss_fn, differentiated."""
    jcfg = JaxConfig().override(overrides)
    model = jax_build(jcfg.model)
    x = jax_train_preprocess(jax.random.PRNGKey(0), jnp.asarray(frames),
                             jcfg.augment, S, jnp.dtype(jcfg.model.dtype))

    def loss_fn(p):
        logits = model.apply({"params": p}, x, train=True,
                             rngs={"dropout": jax.random.PRNGKey(1)})
        return jax_weighted_loss(logits, jnp.asarray(targets),
                                 jnp.asarray(CLASS_WEIGHTS),
                                 jnp.asarray(mask))[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), float(optax.global_norm(grads)), jax.device_get(grads)


# (blocks, model dtype) → tolerances (loss and grad norm relative, each
# parameter's gradient error relative to that gradient's norm).
# kernels, bf16: both packages on their kernels. The two round the K3
# GELU in other places (JAX evaluates it in bf16), and 18 blocks with γ of
# order 1 amplify such 1-ulp flips: measured 1.7% on the loss, 2.8% on the
# grad norm and 9% on the worst parameter, as far apart as the JAX
# package's own kernel and stock paths are from each other.
# stock, float32: the same step with no bf16 rounding anywhere, which holds
# everything around the blocks tightly (measured 2.6e-6 on the worst
# parameter).
STEP_CASES = {"kernels-bf16": (True, "bfloat16", 3e-2, 5e-2, 0.2),
              "stock-float32": (False, "float32", 1e-5, 1e-5, 1e-4)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_training_step_matches_jax(step_inputs, case, monkeypatch):
    kernels, dtype, loss_tol, norm_tol, grad_tol = STEP_CASES[case]
    params, frames, targets, mask = step_inputs
    overrides = dict(OVERRIDES, **{"model.dtype": dtype})
    if kernels:  # the JAX blocks through their Pallas kernels (interpret mode)
        monkeypatch.setattr(dwconv_pallas, "PALLAS_DWCONV_DEFAULT", True)
        monkeypatch.setattr(convnext_mlp_pallas, "FUSED_MLP_DEFAULT", True)
        monkeypatch.setattr(convnext_mlp_pallas, "FUSED_MLP_MIN_DIM", 0)
    ref_loss, ref_norm, ref_grads = _jax_loss_and_grads(
        overrides, params, frames, targets, mask)

    cfg = ExperimentConfig().override(overrides)
    if kernels:
        tmodel, state = create_train_state(
            cfg, torch.Generator().manual_seed(0), steps_per_epoch=10,
            device="cpu")
    else:
        tmodel = build_model(cfg.model, device="cpu", dwconv_kernel=False,
                             fused_mlp=False)
        state = TrainState(*build_optimizer(cfg.optim, tmodel.parameters(),
                                            steps_per_epoch=10))
    want = from_flax_params(ref_grads, dwconv_kernel=kernels)
    tmodel.load_state_dict(from_flax_params(params, dwconv_kernel=kernels),
                           strict=True)
    step = make_train_step(tmodel, cfg, class_weights=CLASS_WEIGHTS)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    launches = (k2.dwconv7x7.launches, k3.convnext_mlp_train.launches)
    state, metrics = step(state, frames, targets, mask,
                          torch.Generator().manual_seed(0))
    # on the CPU the Functions run the plain versions: nothing launched
    assert (k2.dwconv7x7.launches, k3.convnext_mlp_train.launches) == launches
    assert state.step == 1 and tmodel.training

    assert float(metrics["loss"]) == pytest.approx(ref_loss, rel=loss_tol)
    assert float(metrics["grad_norm"]) == pytest.approx(ref_norm,
                                                        rel=norm_tol)
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert got.keys() == want.keys()
    worst = {}
    for name, g in got.items():
        w = want[name]
        assert g is not None and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        worst[name] = float((g - w).norm() / w.norm().clamp_min(1e-12))
    assert max(worst.values()) <= grad_tol, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]
    # every one of the 18 blocks' parameters gets a gradient (with kernels,
    # through the Functions' backward)
    blocks = [n for n in got if ".stage" in n]
    assert len({n.split(".")[1] for n in blocks}) == 18
    assert all(float(got[n].abs().max()) > 0 for n in blocks)
    # AdamW moved every parameter but the GRU's r/z hidden biases, which
    # flax does not have and training keeps at zero
    moved = {k for k, v in tmodel.state_dict().items()
             if not torch.equal(v, before[k])}
    assert moved == set(before)


def test_pretrained_backbone_loads_from_the_jax_npz(step_inputs, tmp_path):
    from vision_collision_detection_tpu.models.convert import save_npz

    backbone = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float16),
                                      step_inputs[0]["backbone"])
    path = str(tmp_path / "backbone_fp16.npz")
    save_npz({"params": backbone}, path)  # the JAX package's artifact
    cfg = ExperimentConfig().override(OVERRIDES)
    fresh, _ = create_train_state(cfg, torch.Generator().manual_seed(0), 1,
                                  device="cpu")
    cfg = cfg.override({"model.pretrained_path": path})
    model, _ = create_train_state(cfg, torch.Generator().manual_seed(0), 1,
                                  device="cpu")
    want = from_flax_params({"backbone": jax.tree_util.tree_map(
        lambda a: a.astype(np.float32), backbone)})
    got, init = model.state_dict(), fresh.state_dict()
    for name, v in got.items():
        if name.startswith("backbone."):  # fp16 on disk, float32 in the model
            assert v.dtype == torch.float32 and torch.equal(v, want[name]), name
        else:  # the heads keep their initial weights
            assert torch.equal(v, init[name]), name


def test_loss_falls_on_a_fixed_batch():
    cfg = ExperimentConfig().override(dict(
        OVERRIDES, **{"optim.learning_rate": 3e-4}))
    model, state = create_train_state(cfg, torch.Generator().manual_seed(1),
                                      steps_per_epoch=100, device="cpu")
    step = make_train_step(model, cfg)
    frames = np.random.default_rng(3).integers(0, 256, (2, 4, *CONTENT, 3),
                                               dtype=np.uint8)
    targets, mask = np.array([0, 2]), np.ones(2, np.float32)
    losses = [float(step(state, frames, targets, mask,
                         torch.Generator().manual_seed(0))[1]["loss"])
              for _ in range(4)]
    assert losses[-1] < losses[0], losses
    out = make_eval_step(model, cfg)(frames, targets, mask)
    assert not model.training
    assert out["probs"].shape == (2, 3) and out["preds"].shape == (2,)
    np.testing.assert_allclose(out["probs"].sum(-1).numpy(), 1.0, atol=1e-6)


def test_dropout_and_drop_path_draw_from_the_generator():
    from vision_collision_detection_tpu_torch.models.backbones import convnext

    cfg = ExperimentConfig().override(dict(OVERRIDES,
                                           **{"model.dropout": 0.5}))
    model, _ = create_train_state(cfg, torch.Generator().manual_seed(2), 1,
                                  device="cpu")
    model.train()
    x = torch.randn(1, 4, S, S, 3).to(torch.bfloat16)
    with torch.no_grad():
        with pytest.raises(ValueError, match="generator"):
            model(x)
        a = model(x, generator=torch.Generator().manual_seed(4))
        b = model(x, generator=torch.Generator().manual_seed(4))
        c = model(x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)

    block = convnext.ConvNeXtBlock(16, layer_scale_init=1.0,
                                   drop_path_rate=0.5, dwconv_kernel=True,
                                   dtype=torch.float32).train()
    torch.nn.init.normal_(block.dwconv.weight, std=0.1)
    xb = torch.randn(64, 6, 6, 16)
    with torch.no_grad():
        out = block(xb, torch.Generator().manual_seed(0))
        full = block.eval()(xb)  # eval: the fused path, nothing dropped
    dropped = (out - xb).flatten(1).abs().amax(1) == 0
    assert 10 < int(dropped.sum()) < 54
    kept = ~dropped
    # kept samples: the unfused branch scaled by 1/keep, against the fused
    # one (bf16 roundings inside the MLP)
    np.testing.assert_allclose((out[kept] - xb[kept]).numpy() * 0.5,
                               (full[kept] - xb[kept]).numpy(), atol=0.05)
    sched = convnext.ConvNeXt((1, 1, 1, 1), (16, 32, 64, 128),
                              drop_path_rate=0.3)
    rates = [m.drop_path_rate for m in sched.modules()
             if isinstance(m, convnext.ConvNeXtBlock)]
    assert rates == pytest.approx([0.0, 0.1, 0.2, 0.3])


def test_rng_tree_is_seeded_and_independent():
    a = port_rng.make_rngs(42)
    b = port_rng.make_rngs(42)
    assert set(a) == {"params", "dropout"}
    draw = lambda g: torch.rand(4, generator=g)  # noqa: E731
    assert torch.equal(draw(a["params"]), draw(b["params"]))
    assert not torch.equal(draw(port_rng.make_rngs(42)["params"]),
                           draw(port_rng.make_rngs(42)["dropout"]))
    e0, e1 = port_rng.epoch_key(42, 0), port_rng.epoch_key(42, 1)
    assert not torch.equal(draw(e0), draw(e1))
    s = [draw(port_rng.batch_key(42, 0, i)) for i in range(3)]
    assert not torch.equal(s[0], s[1]) and not torch.equal(s[1], s[2])
    assert torch.equal(s[0], draw(port_rng.batch_key(42, 0, 0)))
    clips = port_rng.clip_keys(torch.Generator().manual_seed(0), 3)
    assert len({float(draw(g)[0]) for g in clips}) == 3
