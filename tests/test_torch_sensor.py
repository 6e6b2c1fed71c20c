"""The port's sensor branch (the IMU stream fused into the classifier)
against the flax model on bridged weights, after the JAX package's
``tests/test_sensor_fusion.py``; and the train and eval steps with it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (  # noqa: F401
    randomize_params,
    two_torch_threads,
)
from vision_collision_detection_tpu.config import ExperimentConfig as JaxConfig
from vision_collision_detection_tpu.models import build_model as jax_build
from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.models import build_model
from vision_collision_detection_tpu_torch.models.convert import (
    from_flax_params,
)
from vision_collision_detection_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_train_step,
)

S, T = 32, 4
OVERRIDES = {"model.use_sensor": True, "model.dtype": "float32",
             "model.dropout": 0.0, "data.frame_size": S, "data.fps": 2,
             "data.duration": 2, "augment.enabled": False,
             "augment.horizontal_flip_prob": 0.0}


@pytest.fixture(scope="module")
def bridged():
    """Seeded flax parameters of convnext_tiny + GRU with the sensor branch,
    a batch of frames and a non-zero sensor stream, and flax's logits."""
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(2, T, S, S, 3)).astype(np.float32)
    sensor = rng.normal(0, 2, (2, T, 4)).astype(np.float32)
    model = jax_build(JaxConfig().override(OVERRIDES).model)
    init = jax.jit(lambda k, x, s: model.init(k, x, sensor=s))(
        jax.random.PRNGKey(0), jnp.asarray(frames), jnp.asarray(sensor))
    params = randomize_params(jax.device_get(init["params"]),
                              np.random.default_rng(1))
    params["fc_out"]["kernel"] *= 10.0  # logits away from uniform
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(frames),
                                 sensor=jnp.asarray(sensor)))
    return params, frames, sensor, ref


def _port_model(params):
    cfg = ExperimentConfig().override(OVERRIDES)
    model = build_model(cfg.model, device="cpu", dwconv_kernel=False,
                        fused_mlp=False)
    model.load_state_dict(from_flax_params(params, dwconv_kernel=False),
                          strict=True)
    return model


def test_sensor_model_matches_flax_fp32(bridged):
    params, frames, sensor, ref = bridged
    assert {"sensor_fc1", "sensor_fc2"} <= set(params)
    model = _port_model(params)
    assert model.fc1.in_features == 256 + 64
    with torch.no_grad():
        got = model(torch.from_numpy(frames), torch.from_numpy(sensor))
    # tolerance: float32 convolutions and products summed in other orders
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_sensor_changes_the_logits(bridged):
    params, frames, sensor, _ = bridged
    model = _port_model(params)
    x = torch.from_numpy(frames)
    zero = torch.zeros(2, T, 4)
    spike = zero.clone()
    spike[:, 2] = 5.0
    with torch.no_grad():
        base, out = model(x, zero), model(x, spike)
    assert not torch.allclose(base, out)


def test_use_sensor_requires_input(bridged):
    model = _port_model(bridged[0])
    with pytest.raises(ValueError, match="no sensor input"):
        model(torch.zeros(1, T, S, S, 3))


def test_without_use_sensor_the_model_is_unchanged():
    cfg = ExperimentConfig().override(dict(OVERRIDES,
                                           **{"model.use_sensor": False}))
    model = build_model(cfg.model, device="cpu")
    assert not any(k.startswith("sensor_fc") for k in model.state_dict())
    assert model.fc1.in_features == 256


def test_steps_pass_the_sensor():
    cfg = ExperimentConfig().override(OVERRIDES)
    model, state = create_train_state(cfg, torch.Generator().manual_seed(0),
                                      steps_per_epoch=4, device="cpu")
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (2, T, 18, S, 3), dtype=np.uint8)
    sensor = rng.normal(0, 2, (2, T, 4)).astype(np.float32)
    targets, mask = np.array([0, 2]), np.ones(2, np.float32)
    step = make_train_step(model, cfg)
    with pytest.raises(ValueError, match="no sensor input"):
        step(state, frames, targets, mask, torch.Generator().manual_seed(0))
    state, m = step(state, frames, targets, mask,
                    torch.Generator().manual_seed(0), sensor=sensor)
    assert np.isfinite(float(m["loss"]))
    for name in ("sensor_fc1.weight", "sensor_fc2.weight"):
        g = dict(model.named_parameters())[name].grad
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    evaluate = make_eval_step(model, cfg)
    a = evaluate(frames, targets, mask, sensor=sensor)["probs"]
    b = evaluate(frames, targets, mask, sensor=np.zeros_like(sensor))["probs"]
    assert a.shape == (2, 3) and not torch.allclose(a, b)
