"""The port's data parallelism against the JAX package's, on the CPU: the
counterparts of ``tests/test_parallel.py`` and ``tests/test_dp_sensor.py``.

The port's ranks are two child processes over gloo
(``tests/torch_parallel_worker.py``, suite ``dp``), started once for the
module; they import torch and the port only. The JAX side runs here, on two
of the conftest's eight virtual CPU devices
(``create_mesh(MeshConfig(num_data=2, num_model=1), jax.devices()[:2])``),
and its weights reach the ranks through the bridge (``from_flax_params``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parallel_worker import Ranks
from vision_collision_detection_tpu.config import ExperimentConfig as JaxConfig
from vision_collision_detection_tpu.config import MeshConfig as JaxMeshConfig
from vision_collision_detection_tpu.models.vivit import ViViT as JaxViViT
from vision_collision_detection_tpu.parallel import (
    DataParallelStrategy as JaxDP,
)
from vision_collision_detection_tpu.parallel import create_mesh as jax_mesh
from vision_collision_detection_tpu.train import (
    create_train_state as jax_create_train_state,
)
from vision_collision_detection_tpu.train.steps import TrainState
from vision_collision_detection_tpu_torch.config import MeshConfig
from vision_collision_detection_tpu_torch.models.convert import (
    from_flax_params,
)
from vision_collision_detection_tpu_torch.parallel import (
    maybe_initialize_distributed,
    sync_global_devices,
)
from vision_collision_detection_tpu_torch.parallel.mesh import (
    group_ranks,
    mesh_shape,
)

JAX_BN_CONFIG = {
    "model.backbone": "resnet18", "model.temporal_mode": "pooling",
    "model.dtype": "float32", "model.dropout": 0.0, "data.fps": 4,
    "data.duration": 1, "data.frame_size": 32, "data.batch_size": 2,
    "augment.blur_sigma": 0.0, "augment.enabled": False,
    "augment.horizontal_flip_prob": 0.0, "optim.optimizer": "sgd"}


def _save_sd(path, tree):
    np.savez(path, **{k: v.numpy() for k, v in from_flax_params(tree).items()})


def _uint8(rng, shape):
    return (rng.random(shape) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX references and the ranks' results."""
    return dp_results(tmp_path_factory.mktemp("dp"))


def dp_results(tmp, data_seed=3, bn_key=0):
    """The JAX DP steps on two devices and the port's two ranks (suite
    ``dp``) on the same inputs, drawn from ``data_seed``; resnet18's
    initial weights from ``PRNGKey(bn_key)``. → (references, the ranks'
    results). ``scripts/dp_bn_readings.py`` calls it over several draws."""
    rng = np.random.default_rng(data_seed)
    data = {"ln_frames": _uint8(rng, (8, 4, 32, 32, 3)),
            "ln_targets": (np.arange(8) % 3).astype(np.int64),
            "ln_mask": np.ones(8, np.float32),
            "bn_frames": _uint8(rng, (8, 4, 32, 32, 3)),
            "bn_targets": (np.arange(8) % 3).astype(np.int64),
            "bn_mask": np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32),
            "ev_frames": _uint8(rng, (16, 4, 32, 32, 3)),
            "ev_targets": (np.arange(16) % 3).astype(np.int64),
            "ev_mask": np.ones(16, np.float32),
            "sensor": rng.normal(size=(8, 4, 4)).astype(np.float32)}
    np.savez(tmp / "data.npz", **data)

    ln = JaxViViT(dim=32, spatial_layers=1, temporal_layers=1, num_heads=4,
                  patch_size=8, num_classes=3, dtype=jnp.float32)
    ln_vars = jax.jit(lambda k, x: ln.init(k, x, train=False))(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, 4, 32, 32, 3), jnp.float32))
    _save_sd(tmp / "ln.npz", ln_vars["params"])
    cfg = JaxConfig().override(JAX_BN_CONFIG)
    bn_model, bn_state = jax_create_train_state(cfg,
                                                jax.random.PRNGKey(bn_key), 10)
    _save_sd(tmp / "r18.npz", {"params": bn_state.params,
                               "batch_stats": bn_state.batch_stats})
    sensor_cfg = JaxConfig().override(dict(
        JAX_BN_CONFIG, **{"model.use_sensor": True,
                          "model.frame_subsample": 1,
                          "data.load_sensor_data": True}))
    sensor_model, sensor_state = jax_create_train_state(
        sensor_cfg, jax.random.PRNGKey(1), 10)
    _save_sd(tmp / "r18_sensor.npz", {
        "params": sensor_state.params,
        "batch_stats": sensor_state.batch_stats})
    ranks = Ranks("dp", 2, tmp, tmp)

    # while the ranks run: the JAX DP steps on two devices
    dp = JaxDP(jax_mesh(JaxMeshConfig(num_data=2, num_model=1),
                        jax.devices()[:2]))
    sh = dp.data_sharding

    def put(*arrays):
        return [jax.device_put(a, sh) for a in arrays]

    ln_cfg = JaxConfig().override({
        "model.dtype": "float32", "model.dropout": 0.0, "data.fps": 4,
        "data.duration": 1, "data.frame_size": 32, "augment.enabled": False,
        "augment.horizontal_flip_prob": 0.0, "augment.blur_sigma": 0.0})
    ln_state = TrainState.create(apply_fn=ln.apply, params=ln_vars["params"],
                                 batch_stats={}, tx=optax.sgd(1e-4))
    step, _ = dp.make_steps(ln, ln_cfg, None)
    s, m = step(ln_state, *put(data["ln_frames"], data["ln_targets"],
                               data["ln_mask"]), jax.random.PRNGKey(99))
    ref = {"ln_loss": float(m["loss"]),
           "ln_params": from_flax_params(jax.device_get(s.params))}
    step, _ = dp.make_steps(bn_model, cfg, None)
    s, m = step(bn_state, *put(data["bn_frames"], data["bn_targets"],
                               data["bn_mask"]), jax.random.PRNGKey(99))
    ref["bn_loss"] = float(m["loss"])
    ref["bn_state"] = from_flax_params(jax.device_get(
        {"params": s.params, "batch_stats": s.batch_stats}))
    step, _ = dp.make_steps(sensor_model, sensor_cfg, None)
    s, m = step(sensor_state, *put(data["bn_frames"], data["bn_targets"],
                                   data["bn_mask"]), jax.random.PRNGKey(99),
                *put(data["sensor"]))
    ref["sensor_loss"] = float(m["loss"])
    ref["sensor_state"] = from_flax_params(jax.device_get(
        {"params": s.params, "batch_stats": s.batch_stats}))

    ranks.wait(timeout=600)
    got = [torch.load(tmp / f"dp_r{r}.pt", weights_only=True)
           for r in range(2)]
    return ref, got


def _close(got, want, rtol, atol):
    """The names whose tensors differ beyond the tolerance."""
    assert sorted(got) == sorted(want)
    return [k for k in want if not np.allclose(
        got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol)]


@pytest.mark.parametrize("world, cfg, want", [
    (8, None, (8, 1)),
    (8, MeshConfig(num_data=4, num_model=2), (4, 2)),
    (8, MeshConfig(num_model=2), (4, 2)),
    (2, MeshConfig(num_data=1, num_model=2), (1, 2)),
    (8, MeshConfig(num_data=3, num_model=2), ValueError),
    (6, MeshConfig(num_model=4), ValueError),
])
def test_mesh_shape(world, cfg, want):
    """``create_mesh``'s arithmetic, as the JAX ``create_mesh``'s
    (``tests/test_parallel.py:41-48``)."""
    if want is ValueError:
        with pytest.raises(ValueError):
            mesh_shape(cfg, world)
    else:
        assert mesh_shape(cfg, world) == want


def test_initialize_is_a_noop_without_torchrun(monkeypatch):
    """Without torchrun's variables there is no process group to join;
    ``sync_global_devices`` is then a no-op too."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    maybe_initialize_distributed()
    assert not torch.distributed.is_initialized()
    sync_global_devices("nothing to wait for")


def test_group_ranks_put_the_model_axis_innermost():
    data, model = group_ranks(2, 2)
    assert data == [[0, 2], [1, 3]] and model == [[0, 1], [2, 3]]
    data, model = group_ranks(4, 1)
    assert data == [[0, 1, 2, 3]] and model == [[0], [1], [2], [3]]


def test_strategy_contract(run):
    _, got = run
    assert [g["shard"] for g in got] == [(2, 0, 1, True, True),
                                         (2, 1, 1, True, False)]


def test_two_rank_step_matches_one_device_and_jax(run):
    """The LayerNorm ViViT (SGD, float32): the 2-rank step on 4 clips each
    equals the 1-rank step on all 8 and the JAX DP step on two devices
    (``test_1_vs_8_device_parity``'s tolerances: loss rel 1e-5, parameters
    rtol 5e-5 / atol 1e-5); both ranks hold the same parameters."""
    ref, got = run
    r0, r1 = got
    assert all(torch.equal(r0["ln_dp_params"][k], r1["ln_dp_params"][k])
               for k in r0["ln_dp_params"])
    assert r0["ln_dp_metrics"] == r1["ln_dp_metrics"]
    loss = r0["ln_dp_metrics"]["loss"]
    assert loss == pytest.approx(r0["ln_single_metrics"]["loss"], rel=1e-5)
    assert loss == pytest.approx(ref["ln_loss"], rel=1e-5)
    assert r0["ln_dp_metrics"]["grad_norm"] == pytest.approx(
        r0["ln_single_metrics"]["grad_norm"], rel=1e-5)
    assert not _close(r0["ln_dp_params"], r0["ln_single_params"], 5e-5, 1e-5)
    assert not _close(r0["ln_dp_params"], ref["ln_params"], 5e-5, 1e-5)


def test_averaged_gradients_land_outside(run):
    """DDP's own hook averages the gradients over the data group where the
    JAX step sums them: that step's parameters land outside the bounds the
    summed step meets."""
    _, (r0, _) = run
    assert _close(r0["ln_avg_params"], r0["ln_single_params"], 5e-5, 1e-5)


def _stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean",
                                                       "running_var"))}


def _check_bn_step(metrics, state, want_loss, want_state):
    """The loss (rel 1e-5), the parameters (rtol 5e-5 / atol 1e-5) and the
    running statistics, elementwise within 1e-6 + 1e-6·|JAX's|: both
    frameworks form the batch variance as E[x²] − E[x]² in float32 over
    4,096 values a channel, and the JAX step ``pmean``s it. These inputs
    read 1.07e-6; five draws of ``scripts/dp_bn_readings.py`` read at most
    1.91e-6, 0.88 of this tolerance, where unsynchronised statistics are
    1e-3 or more apart."""
    assert metrics["loss"] == pytest.approx(want_loss, rel=1e-5)
    params = {k: v for k, v in state.items() if k not in _stats(state)}
    assert not _close(params, {k: want_state[k] for k in params}, 5e-5, 1e-5)
    stats = _stats(state)
    assert stats
    assert not _close(stats, {k: want_state[k] for k in stats}, 1e-6, 1e-6)


def test_batchnorm_step_matches_jax_pmean(run):
    """resnet18 with pooling (BatchNorm), SGD, float32, one masked clip:
    the 2-rank step against the JAX DP step on two devices."""
    ref, (r0, _) = run
    _check_bn_step(r0["bn_dp_metrics"], r0["bn_dp_state"], ref["bn_loss"],
                   ref["bn_state"])


def test_batchnorm_statistics_are_the_ranks_mean(run):
    """After the step both ranks hold the same running statistics, the mean
    of the two ranks' own single-device updates (within 1e-6); without the
    mean (each rank's own update) the ranks differ by far more."""
    _, (r0, r1) = run
    s0, s1 = _stats(r0["bn_dp_state"]), _stats(r1["bn_dp_state"])
    assert s0 and all(torch.equal(s0[k], s1[k]) for k in s0)
    o0, o1 = _stats(r0["bn_own_state"]), _stats(r1["bn_own_state"])
    spread = []
    for k in s0:
        mean = (o0[k] + o1[k]) / 2
        assert float((s0[k] - mean).abs().max()) <= 1e-6, k
        spread.append(float((o0[k] - o1[k]).abs().max()))
    # the fault the mean repairs: each rank keeping its own update
    assert max(spread) > 1e-3


def test_dp_eval_gathers_probabilities_and_global_loss(run):
    """Each rank evaluates 8 of 16 clips: the gathered probabilities (in
    rank order) sum to 1 and equal one device's; the loss is the global
    batch's on both ranks."""
    _, (r0, r1) = run
    assert r0["ev_probs"].shape == (16, 3)
    assert torch.equal(r0["ev_probs"], r1["ev_probs"])
    assert not bool(r0["ev_pad"].any()) and r0["ev_pad"].dtype == torch.bool
    np.testing.assert_allclose(r0["ev_probs"].sum(1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(r0["ev_probs"].numpy(),
                               r0["ev_single_probs"].numpy(), atol=1e-5)
    assert r0["ev_loss"] == r1["ev_loss"]
    assert r0["ev_loss"] == pytest.approx(r0["ev_single_loss"], rel=1e-5)


def test_dp_step_with_the_sensor_branch(run):
    """``test_dp_with_sensor_fusion``: resnet18 + pooling with the sensor
    stream sharded with the batch, against the JAX DP step (as the
    BatchNorm step); the evaluation's probabilities sum to 1."""
    ref, (r0, r1) = run
    assert r0["sensor_dp_metrics"] == r1["sensor_dp_metrics"]
    _check_bn_step(r0["sensor_dp_metrics"], r0["sensor_dp_state"],
                   ref["sensor_loss"], ref["sensor_state"])
    np.testing.assert_allclose(r0["sensor_probs"].sum(1).numpy(), 1.0,
                               atol=1e-5)


def test_trainer_with_dp_strategy(run):
    """``Trainer`` + ``DataParallelStrategy`` over one shared run directory:
    a batch of one clip per device, 8 training clips in 4 steps a rank, one
    epoch, then ``test()`` on 3 clips (the wrap pad trimmed after the
    gather); both ranks see the same results and the same checkpoints,
    which rank 0 alone wrote (``best`` and ``last``)."""
    _, (r0, r1) = run
    assert r0["tr_batch_size"] == 1 and r0["tr_steps"] == 4
    assert r0["tr_num_samples"] == r1["tr_num_samples"] == 3
    assert sorted(r0["tr_ids"]) == ["clip00", "clip01", "clip02"]
    assert r0["tr_ids"] == r1["tr_ids"]
    assert torch.equal(r0["tr_preds"], r1["tr_preds"])
    assert np.isfinite(r0["tr_loss"]) and r0["tr_loss"] == r1["tr_loss"]
    assert r0["tr_roles"] == r1["tr_roles"] == ["best", "last"]
    assert r0["tr_files"] == r1["tr_files"]
    assert not any(f.endswith(".tmp") for f in r0["tr_files"])
    assert r0["tr_writes"] == 2 and r1["tr_writes"] == 0
