"""The port's BatchNorm backbones against the JAX package's: flax's
BatchNorm update (the biased variance, flax's momentum), resnet18,
mobilenet_v2, mobilenet_v3_small and efficientnet_v2_s forward in float32
on bridged weights and random running statistics, resnet50 and
efficientnet_v2_m/l on structure (the flax tree's shapes and the
torchvision manifests), two training steps of resnet18 + the conv head
in both packages, the committed pretrained fixture, and a ``Trainer``
resume of a BatchNorm model."""

import os
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import torch.nn.functional as F

from torch_port_helpers import randomize_params, two_torch_threads  # noqa: F401
from vision_collision_detection_tpu.config import ExperimentConfig as JaxConfig
from vision_collision_detection_tpu.models import build_model as jax_build
from vision_collision_detection_tpu.models.backbones import (
    build_backbone as jax_backbone,
)
from vision_collision_detection_tpu.train import optim as jax_optim
from vision_collision_detection_tpu.train.steps import (
    weighted_loss as jax_weighted_loss,
)
from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.data import (
    create_datasets_with_manual_split,
)
from vision_collision_detection_tpu_torch.media.synthetic import (
    generate_dataset,
)
from vision_collision_detection_tpu_torch.models import build_model
from vision_collision_detection_tpu_torch.models.backbones import (
    build_backbone,
    feature_dim,
)
from vision_collision_detection_tpu_torch.models.convert import (
    from_flax_params,
    load_flax_params,
    load_npz,
)
from vision_collision_detection_tpu_torch.models.import_torch import (
    convert_torch_state_dict,
    load_manifest,
)
from vision_collision_detection_tpu_torch.models.norm import BatchNorm
from vision_collision_detection_tpu_torch.train import (
    TrainState,
    Trainer,
    build_optimizer,
    create_train_state,
    make_train_step,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "pretrained",
                       "mobilenet_v3_small_seeded_fp16.npz")


def _zeros_like_shapes(tree):
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), tree)


def _flax_variables(module, x, seed):
    """Seeded variables of a flax module for input ``x``: shapes by
    ``jax.eval_shape`` (no compile), every parameter redrawn, running means
    in ±0.2 and variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)
    params = randomize_params(_zeros_like_shapes(shapes["params"]), rng)

    def stats(tree):
        return {k: stats(v) if isinstance(v, dict) else
                (rng.uniform(-0.2, 0.2, v.shape) if k == "mean" else
                 rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
                for k, v in tree.items()}

    return {"params": params,
            "batch_stats": stats(_zeros_like_shapes(
                shapes.get("batch_stats", {})))}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---- flax's BatchNorm -----------------------------------------------------

def _flax_bn(x, momentum=0.9, eps=1e-5):
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum,
                       epsilon=eps)
    v = bn.init(jax.random.PRNGKey(0), x)
    y, upd = bn.apply(v, x, mutable=["batch_stats"])
    return np.asarray(y), jax.device_get(upd["batch_stats"])


@pytest.mark.parametrize("momentum,eps", [(0.9, 1e-5), (0.99, 1e-3)])
def test_batchnorm_update_is_flax(momentum, eps):
    """The biased batch variance for the normalisation and the update,
    ``running = m·running + (1 − m)·batch`` with flax's m, and eps as
    given; torch's stock layer (unbiased update, its momentum 1 − m) would
    put the variance 8/7 further on an [8, 4] batch."""
    x = np.random.default_rng(0).normal(1.0, 1.5, (8, 4)).astype(np.float32)
    want_y, want = _flax_bn(jnp.asarray(x), momentum, eps)
    bn = BatchNorm(4, momentum=momentum, eps=eps).train()
    y = bn(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=0, atol=1e-6)
    assert _rel(bn.running_mean.numpy(), want["mean"]) < 1e-6
    assert _rel(bn.running_var.numpy(), want["var"]) < 1e-6

    stock = torch.nn.BatchNorm1d(4, momentum=1 - momentum, eps=eps).train()
    stock(torch.from_numpy(x))
    # the same update's mean; the batch variance it takes in off by the
    # unbiased factor n/(n − 1)
    assert _rel(stock.running_mean.numpy(), want["mean"]) < 1e-6
    m = momentum
    taken = (stock.running_var.numpy() - m) / (want["var"] - m)
    np.testing.assert_allclose(taken, 8 / 7, rtol=1e-4)

    bn.eval()  # eval normalises with the running statistics
    y = bn(torch.from_numpy(x)).detach().numpy()
    ref = ((x - bn.running_mean.numpy()) / np.sqrt(bn.running_var.numpy()
                                                   + eps))
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-5)


def test_batchnorm_bf16_input_reduces_in_float32():
    """A bf16 NHWC input with float32 buffers: statistics reduced in
    float32 (the update equals the one of the same values in float32), the
    output in the compute dtype."""
    x = torch.randn(4, 5, 5, 8, generator=torch.Generator().manual_seed(1))
    xb = (x * 3 + 100).to(torch.bfloat16)  # a large mean: bf16 sums would drift
    bn = BatchNorm(8, dtype=torch.bfloat16).train()
    ref = BatchNorm(8).train()
    y = bn(xb)
    ref(xb.float())
    assert y.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    assert torch.equal(bn.running_mean, ref.running_mean)
    assert torch.equal(bn.running_var, ref.running_var)


# ---- the four backbones held in full ---------------------------------------

FULL = {"resnet18": 64, "mobilenet_v2": 64, "mobilenet_v3_small": 64,
        "efficientnet_v2_s": 64}


@pytest.mark.parametrize("name", list(FULL))
def test_backbone_matches_flax(name):
    """Eval (running statistics) and train mode (batch statistics and
    their update) on bridged weights, 4 frames in float32. Tolerances: the
    eval forward within 1e-4 of the output's largest value (float32
    convolutions summed in other orders; measured under 1e-6). Train mode
    normalises the deepest layers over 4 frames of 1×1 to 2×2, which
    amplifies those differences: its output within 1e-3 of the largest
    value (measured up to 1.6e-4, mobilenet_v2) and its updated statistics
    within 3e-5 relative to their norm (measured up to 9.6e-6)."""
    S = FULL[name]
    x = np.random.default_rng(0).normal(size=(4, S, S, 3)).astype(np.float32)
    fm = jax_backbone(name, dtype=jnp.float32)
    v = _flax_variables(fm, jnp.asarray(x), seed=1)
    ref = np.asarray(jax.jit(lambda v, x: fm.apply(v, x))(v, jnp.asarray(x)))
    ref_tr, upd = jax.jit(lambda v, x: fm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))

    tm = build_backbone(name, dtype=torch.float32)
    load_flax_params(tm, v)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
        got_tr = tm.train()(torch.from_numpy(x)).numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(got_tr, np.asarray(ref_tr), rtol=0,
                               atol=1e-3 * float(np.abs(ref_tr).max()))
    want = from_flax_params({"params": v["params"],
                             "batch_stats": upd["batch_stats"]})
    sd = tm.state_dict()
    worst = max(_rel(sd[k], w) for k, w in want.items() if "running" in k)
    assert worst < 3e-5, worst


# ---- the three held on structure --------------------------------------------

ALL_BN = ("resnet18", "resnet50", "mobilenet_v2", "mobilenet_v3_small",
          "efficientnet_v2_s", "efficientnet_v2_m", "efficientnet_v2_l")


@pytest.fixture(scope="module")
def port_backbones():
    return {}


def _port(port_backbones, name):
    if name not in port_backbones:
        port_backbones[name] = build_backbone(name, dtype=torch.float32)
    return port_backbones[name]


@pytest.mark.parametrize("name", ["resnet50", "efficientnet_v2_m",
                                  "efficientnet_v2_l"])
def test_large_backbone_structure_and_forward(name, port_backbones):
    """The state_dict has the flax tree's leaves (``jax.eval_shape``, no
    compile) at their shapes, bridged; and one CPU forward at 32²."""
    fm = jax_backbone(name, dtype=jnp.float32)
    shapes = jax.eval_shape(fm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3), jnp.float32))
    want = from_flax_params(_zeros_like_shapes(dict(shapes)))
    tm = _port(port_backbones, name)
    got = tm.state_dict()
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape for k in want)
    with torch.no_grad():
        y = tm.eval()(torch.randn(2, 32, 32, 3))
    assert y.shape == (2, feature_dim(name))
    assert bool(torch.isfinite(y).all())


@pytest.mark.parametrize("name", ALL_BN)
def test_torchvision_manifest_maps_onto_the_port(name, port_backbones):
    """A torchvision state_dict of the manifest's keys and shapes (the
    port's copy) converts onto the port's state_dict key for key."""
    manifest = load_manifest(name)
    sd = {k: np.zeros(s, np.float32) for k, s in manifest.items()}
    tree = convert_torch_state_dict(sd, name, validate=True)
    got = from_flax_params(tree)
    want = _port(port_backbones, name).state_dict()
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape for k in want)
    with pytest.raises(ValueError, match="missing"):
        convert_torch_state_dict(
            {k: v for k, v in sd.items() if "bn1" not in k and
             "0.1." not in k}, name, validate=True)


# ---- training with batch statistics ------------------------------------------

S = 64
BN_OVERRIDES = {"model.backbone": "resnet18", "model.temporal_mode": "conv",
                "model.temporal_hidden_dim": 32, "model.dtype": "float32",
                "model.dropout": 0.0, "data.frame_size": S,
                "optim.optimizer": "sgd", "optim.learning_rate": 1e-3}
CLASS_WEIGHTS = np.array([1.0, 2.0, 0.5], np.float32)


@pytest.fixture(scope="module")
def bn_steps():
    """Two training steps of resnet18 + the conv head (B=3, T=10 frames of
    64²) in the JAX package: its model with mutable ``batch_stats``, its
    loss and its optimizer (SGD: AdamW would turn the conv head's biases'
    gradients, zero in exact math because a BatchNorm follows them, into
    steps of the full rate in both packages, each package's own noise);
    → (initial variables, the batch, the first step's gradients, the
    variables after each step)."""
    jcfg = JaxConfig().override(BN_OVERRIDES)
    model = jax_build(jcfg.model)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 10, S, S, 3)).astype(np.float32)
    targets, mask = np.array([0, 2, 1]), np.ones(3, np.float32)
    v0 = _flax_variables(model, jnp.asarray(x), seed=4)
    tx, _ = jax_optim.build_optimizer(jcfg.optim, steps_per_epoch=10)

    def loss_fn(p, stats):
        logits, upd = model.apply({"params": p, "batch_stats": stats},
                                  jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        loss = jax_weighted_loss(logits, jnp.asarray(targets),
                                 jnp.asarray(CLASS_WEIGHTS),
                                 jnp.asarray(mask))[0]
        return loss, upd["batch_stats"]

    @jax.jit
    def step(p, stats, opt):
        (loss, stats), g = jax.value_and_grad(loss_fn, has_aux=True)(p, stats)
        upd, opt = tx.update(g, opt, p)
        return (jax.tree_util.tree_map(lambda a, b: a + b, p, upd), stats,
                opt, g)

    p, stats, opt = v0["params"], v0["batch_stats"], tx.init(v0["params"])
    after, grads = [], None
    for _ in range(2):
        p, stats, opt, g = step(p, stats, opt)
        grads = jax.device_get(g) if grads is None else grads
        after.append(jax.device_get({"params": p, "batch_stats": stats}))
    return v0, x, targets, mask, grads, after


def _port_steps(v0, x, targets, mask, n=2, dtype=torch.float32):
    """The port's step ``n`` times from ``v0``; → (the state_dict after
    each, the first step's gradients)."""
    cfg = ExperimentConfig().override(BN_OVERRIDES)
    model = build_model(cfg.model, device="cpu")
    if dtype != torch.float32:  # the same model in float64 math
        model.dtype = dtype
        for m in model.modules():
            if hasattr(m, "dtype"):
                m.dtype = dtype
        model.double()
    load_flax_params(model, v0)
    state = TrainState(*build_optimizer(cfg.optim, model.parameters(),
                                        steps_per_epoch=10))
    step = make_train_step(model, cfg, class_weights=CLASS_WEIGHTS,
                           preprocess=False)
    out, grads = [], None
    for _ in range(n):
        state, _ = step(state, torch.from_numpy(x).to(dtype), targets, mask,
                        torch.Generator().manual_seed(0))
        if grads is None:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        out.append({k: v.clone() for k, v in model.state_dict().items()})
    return out, grads


def _worst(got, want, which):
    return max((_rel(got[k], w), k) for k, w in want.items()
               if ("running" in k) == (which == "stats"))


def _tree_rel(got, want, keys):
    return _rel(np.concatenate([got[k].numpy().ravel() for k in keys]),
                np.concatenate([want[k].numpy().ravel() for k in keys]))


def test_bn_training_steps_match_flax(bn_steps):
    """The running statistics after each step against flax's
    ``batch_stats`` (the whole tree, relative to its norm), each parameter
    relative to its norm. The first step: 1e-6 and 1e-5. The second step
    starts from weights that the first step's gradients moved, and those
    gradients are ill-conditioned in float32 in both packages (train-mode
    BatchNorms over 30 frames of random features): they are held against
    the same step in float64, where the port's may be no further off than
    twice the JAX package's; the second step then within 3e-6 and 3e-5.
    Each forward updates the statistics once (the step runs one forward)."""
    v0, x, targets, mask, jax_grads, after = bn_steps
    got, grads = _port_steps(v0, x, targets, mask)
    for i, (g, want, tol) in enumerate(zip(got, after, (1.0, 3.0))):
        w = from_flax_params(want)
        assert g.keys() == w.keys()
        stats = [k for k in w if "running" in k]
        assert len(stats) == 2 * (20 + 2)
        assert _tree_rel(g, w, stats) < 1e-6 * tol, i
        worst = _worst(g, w, "params")
        assert worst[0] < 1e-5 * tol, (i, worst)

    _, grads64 = _port_steps(v0, x, targets, mask, n=1, dtype=torch.float64)
    jax_grads = from_flax_params(jax_grads)
    # the conv head's biases feed a BatchNorm: their true gradient is 0
    held = [k for k in grads64 if not k.startswith("temporal.conv")
            or k.endswith("weight")]
    port_err = max(_rel(grads[k], grads64[k]) for k in held)
    jax_err = max(_rel(jax_grads[k], grads64[k]) for k in held)
    assert port_err <= 2 * jax_err + 1e-6, (port_err, jax_err)


def test_torch_stock_update_misses_flax(bn_steps, monkeypatch):
    """The first step with torch's stock BatchNorm update (the unbiased
    variance, torch's momentum 1 − m) lands outside the 1e-6."""
    def stock(self, x):
        C = self.num_features
        y = F.batch_norm(x.to(torch.float32).reshape(-1, C),
                         self.running_mean, self.running_var, self.weight,
                         self.bias, self.training, 1 - self.momentum,
                         self.eps)
        return y.reshape(x.shape).to(self.dtype or x.dtype)

    monkeypatch.setattr(BatchNorm, "forward", stock)
    v0, x, targets, mask, _, after = bn_steps
    got = _port_steps(v0, x, targets, mask, n=1)[0][0]
    w = from_flax_params(after[0])
    worst = _tree_rel(got, w, [k for k in w if "running" in k])
    assert worst > 1e-4, worst


# ---- the committed pretrained fixture ----------------------------------------

def test_pretrained_fixture_loads_with_batch_stats_and_finetunes():
    """``load_pretrained_backbone`` takes the fixture's params and
    ``batch_stats`` (fp16 on disk) into the backbone, each bit-equal to its
    float32 cast; three steps on a fixed batch: the loss is finite and
    falls."""
    cfg = ExperimentConfig().override({
        "model.backbone": "mobilenet_v3_small",
        "model.temporal_mode": "pooling", "model.pretrained_path": FIXTURE,
        "model.dropout": 0.0, "data.fps": 2, "data.duration": 2,
        "data.frame_size": 64, "optim.learning_rate": 1e-3,
        "augment.enabled": False, "augment.horizontal_flip_prob": 0.0})
    model, state = create_train_state(cfg, torch.Generator().manual_seed(0),
                                      steps_per_epoch=2, device="cpu")
    tree = load_npz(FIXTURE)
    assert tree["batch_stats"]
    want = from_flax_params(jax.tree_util.tree_map(
        lambda a: a.astype(np.float32), tree))
    got = model.backbone.state_dict()
    assert got.keys() == want.keys()
    assert sum("running_var" in k for k in want) == 34
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], w), k

    step = make_train_step(model, cfg)
    frames = np.random.default_rng(0).integers(0, 255, (2, 4, 64, 64, 3),
                                               np.uint8)
    targets, mask = np.array([0, 2]), np.ones(2, np.float32)
    losses = [float(step(state, frames, targets, mask,
                         torch.Generator().manual_seed(0))[1]["loss"])
              for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert not torch.equal(model.backbone.stem_bn.running_var,
                           want["stem_bn.running_var"])


# ---- Trainer resume of a BatchNorm model -------------------------------------

def _tiny_bn_config(**over):
    return ExperimentConfig().override({
        "model.backbone": "mobilenet_v3_small", "model.temporal_mode": "conv",
        "model.temporal_hidden_dim": 16, "model.dtype": "float32",
        "data.fps": 5, "data.duration": 1, "data.frame_size": 32,
        "data.batch_size": 3, "data.num_workers": 2, "train.epochs": 2,
        "train.validation_freq": 0, "train.log_every_steps": 0,
        "train.checkpoint_every_epochs": 0, "optim.learning_rate": 1e-3,
        "augment.blur_sigma": 0.0, **over})


@pytest.fixture(scope="module")
def bn_splits(tmp_path_factory):
    root = tmp_path_factory.mktemp("bn_trainer")
    csv_path = generate_dataset(str(root), clips_per_class=2, num_frames=12,
                                height=40, width=56,
                                splits=("train", "train", "val"))
    df = pd.read_csv(csv_path).fillna({"sensor_path": ""})
    train, val, _ = create_datasets_with_manual_split(
        df, fps=5, duration=1, frame_size=32)
    yield train, val
    shutil.rmtree(root, ignore_errors=True)


def _last(run_dir):
    from vision_collision_detection_tpu_torch.ckpt import CheckpointStore

    return CheckpointStore(run_dir).load("last")[0]


@pytest.mark.parametrize("fault", [None, "running_stats_reset"])
def test_trainer_resume_of_a_bn_model_is_bit_equal(bn_splits, tmp_path,
                                                   monkeypatch, fault):
    """Two epochs straight against one epoch, then a resume for the second:
    the saved model (running statistics included) bit-equal, and the
    resumed trainer starts from the saved statistics. A resume whose
    running statistics are reset to 0 and 1 lands outside."""
    train, val = bn_splits
    whole = Trainer(_tiny_bn_config(), train, val,
                    run_dir=str(tmp_path / "whole"), device="cpu")
    whole.train()
    first = Trainer(_tiny_bn_config(), train, val,
                    run_dir=str(tmp_path / "first"), device="cpu")
    first.train(epochs=1)
    saved = _last(first.run_dir)["model"]
    shutil.copytree(first.store.path("last"),
                    os.path.join(str(tmp_path / "resume"), "last"))
    if fault:
        restore = Trainer._restore_arrays

        def reset(self, arrays):
            model = {k: (torch.zeros_like(v) if k.endswith("running_mean")
                         else torch.ones_like(v)
                         if k.endswith("running_var") else v)
                     for k, v in arrays["model"].items()}
            restore(self, dict(arrays, model=model))

        monkeypatch.setattr(Trainer, "_restore_arrays", reset)
    resumed = Trainer(_tiny_bn_config(**{"train.resume": True}), train, val,
                      run_dir=str(tmp_path / "resume"), device="cpu")
    stats = [k for k in saved if "running" in k]
    assert len(stats) == 2 * (34 + 2)  # the backbone's and the head's
    if not fault:
        now = resumed.model.state_dict()
        assert all(torch.equal(now[k], saved[k]) for k in stats)
    resumed.train(epochs=2)
    got, want = _last(resumed.run_dir)["model"], _last(whole.run_dir)["model"]
    diff = max(float((got[k] - v).abs().max()) for k, v in want.items())
    if fault:
        assert diff > 1e-4, diff
    else:
        assert diff == 0.0
        assert not torch.equal(want["temporal.bn1.running_var"],
                               saved["temporal.bn1.running_var"])
