"""The port's attention, conv, pooling, rnn and lstm heads against the
flax heads of ``vision_collision_detection_tpu/models/temporal.py`` in
float32 on bridged weights: forward, the gradients of every parameter and
of the input, the attention weights, the conv head's BatchNorm statistics,
the frozen recurrent biases, the attention dropout's generator; and the
whole ``VideoClassifierModel`` with each head against the flax model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import randomize_params, two_torch_threads  # noqa: F401
from vision_collision_detection_tpu.config import ExperimentConfig as JaxConfig
from vision_collision_detection_tpu.models import build_model as jax_build
from vision_collision_detection_tpu.models.temporal import (
    build_temporal_head as jax_head,
)
from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.models import build_model
from vision_collision_detection_tpu_torch.models.convert import (
    from_flax_params,
    load_flax_params,
)
from vision_collision_detection_tpu_torch.models.temporal import (
    build_temporal_head,
)

B, T, D, H = 3, 7, 16, 12
MODES = ("attention", "conv", "pooling", "rnn", "lstm")


def _variables(module, x, seed):
    init = module.init(jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)
    v = {"params": randomize_params(jax.device_get(init.get("params", {})),
                                    rng)}
    if "batch_stats" in init:
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
            jax.device_get(init["batch_stats"]))
    return v


def _flax_head(mode, x, train):
    """(output, d sum(out·w) / d params, d / d x, attention weights or
    None, updated batch_stats or None) of the flax head."""
    fm = jax_head(mode, D, hidden=H, num_heads=4, max_seq_length=10,
                  dtype=jnp.float32)
    v = _variables(fm, jnp.asarray(x), seed=1)
    w = jnp.asarray(np.random.default_rng(2).normal(
        size=(B, H if mode in ("conv", "rnn", "lstm") else D)),
        jnp.float32)

    def loss(params, x):
        out, aux = fm.apply(dict(v, params=params), x, train=train,
                            mutable=["intermediates", "batch_stats"])
        return jnp.sum(out * w), (out, aux)

    (_, (out, aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    attn = aux.get("intermediates", {}).get("attention_weights")
    return (v, np.asarray(w), np.asarray(out), jax.device_get(gp),
            np.asarray(gx), None if attn is None else np.asarray(attn[0]),
            jax.device_get(aux.get("batch_stats")))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_head_matches_flax(mode, train):
    """Forward and every gradient within 1e-5 (float32 products summed in
    other orders); in training the conv head's BatchNorm statistics and
    their update; the attention weights readable after the forward."""
    x = np.random.default_rng(0).normal(size=(B, T, D)).astype(np.float32)
    v, w, ref, gp, gx, attn, stats = _flax_head(mode, x, train)

    tm = build_temporal_head(mode, D, hidden=H, num_heads=4,
                             max_seq_length=10, dtype=torch.float32)
    if v["params"]:
        tm.load_state_dict(from_flax_params(v), strict=True)
    tm.train(train)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt, torch.Generator().manual_seed(0))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=0, atol=1e-5)
    want = from_flax_params(gp) if gp else {}
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    if mode == "attention":
        np.testing.assert_allclose(tm.last_attention_weights.numpy(), attn,
                                   rtol=0, atol=1e-6)
        assert tm.last_attention_weights.shape == (B, 4, T, T)
    if mode == "conv" and train:
        upd = from_flax_params({"params": v["params"], "batch_stats": stats})
        for k in ("bn1.running_mean", "bn1.running_var", "bn2.running_mean",
                  "bn2.running_var"):
            np.testing.assert_allclose(tm.state_dict()[k].numpy(),
                                       upd[k].numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode,frozen", [("rnn", "bias_hh"),
                                         ("lstm", "bias_ih"),
                                         ("gru", "bias_hh")])
def test_frozen_recurrent_bias_stays_zero(mode, frozen):
    """The torch bias that flax's cell does not have gets no gradient (the
    GRU's r and z parts of ``bias_hh``; all of it for the others), so
    training keeps it at zero; the other bias trains."""
    tm = build_temporal_head(mode, D, hidden=H)
    cell = getattr(tm, mode)
    with torch.no_grad():
        for name, p in cell.named_parameters():
            if name.startswith(frozen):
                p.zero_()
    tm(torch.randn(B, T, D)).sum().backward()
    for name, p in cell.named_parameters():
        if name.startswith(frozen):
            zero = p.grad[:2 * H] if mode == "gru" else p.grad
            assert torch.count_nonzero(zero) == 0, name
            if mode == "gru":
                assert torch.count_nonzero(p.grad[2 * H:]) > 0
        elif name.startswith("bias"):
            assert torch.count_nonzero(p.grad) > 0, name


def test_attention_dropout_draws_from_the_generator():
    tm = build_temporal_head("attention", D, num_heads=4, dropout=0.5,
                             dtype=torch.float32).train()
    x = torch.randn(B, T, D)
    a = tm(x, torch.Generator().manual_seed(1))
    b = tm(x, torch.Generator().manual_seed(1))
    c = tm(x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        tm(x)
    tm.eval()
    assert torch.equal(tm(x), tm(x))  # no dropout in eval


def test_every_mode_and_backbone_builds():
    """All 10 frame backbones with all 6 temporal modes (on the meta
    device: nothing is allocated), each head's output width feeding the
    classifier."""
    from vision_collision_detection_tpu_torch.config import BACKBONES
    from vision_collision_detection_tpu_torch.models.backbones import (
        feature_dim,
    )
    from vision_collision_detection_tpu_torch.models.temporal import (
        temporal_out_dim,
    )
    from vision_collision_detection_tpu_torch.models.video_classifier import (
        VideoClassifierModel,
    )

    names = [n for n in BACKBONES if not n.startswith("vivit")]
    assert len(names) == 10
    for name in names:
        for mode in MODES + ("gru",):
            with torch.device("meta"):
                model = VideoClassifierModel(backbone=name,
                                             temporal_mode=mode)
            assert model.fc1.in_features == temporal_out_dim(
                mode, feature_dim(name), 256), (name, mode)


@pytest.mark.parametrize("mode", MODES)
def test_video_classifier_with_each_head_matches_flax(mode):
    """resnet18 + the head + the classifier MLP on 4 frames of 32² in
    float32, eval: logits within 1e-5 of the largest."""
    over = {"model.backbone": "resnet18", "model.temporal_mode": mode,
            "model.temporal_hidden_dim": 24, "model.dtype": "float32",
            "data.frame_size": 32}
    x = np.random.default_rng(5).normal(size=(2, 4, 32, 32, 3)).astype(
        np.float32)
    fm = jax_build(JaxConfig().override(over).model)
    shapes = jax.eval_shape(fm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(6)
    v = {"params": randomize_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]), rng),
         "batch_stats": jax.tree_util.tree_map(
             lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
             shapes["batch_stats"])}
    ref = np.asarray(jax.jit(lambda v, x: fm.apply(v, x))(v, jnp.asarray(x)))
    tm = build_model(ExperimentConfig().override(over).model, device="cpu")
    load_flax_params(tm, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))
