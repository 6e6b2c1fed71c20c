"""The port's tensor parallelism against the JAX package's, on the CPU: the
counterparts of ``tests/test_tp.py``.

The sharding rules are held against the JAX rules by parameter name. The
rest runs in two child processes over gloo, model size 2
(``tests/torch_parallel_worker.py``, suite ``tp``), started once for the
module; the JAX ``ModelParallelStrategy`` runs here on a ``(1, 2)`` mesh of
the conftest's virtual CPU devices. The model has vivit_small's widths
(dim 384, 6 heads of 64, MLP 1536) at two spatial blocks and one temporal
one, patch 8 on 16² frames, float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import randomize_params
from torch_parallel_worker import Ranks, _tp_vivit
from vision_collision_detection_tpu.config import ExperimentConfig as JaxConfig
from vision_collision_detection_tpu.config import MeshConfig as JaxMeshConfig
from vision_collision_detection_tpu.models.vivit import ViViT as JaxViViT
from vision_collision_detection_tpu.parallel import create_mesh as jax_mesh
from vision_collision_detection_tpu.parallel.tp import (
    ModelParallelStrategy as JaxTP,
)
from vision_collision_detection_tpu.parallel.tp import param_shardings
from vision_collision_detection_tpu.train.steps import TrainState
from vision_collision_detection_tpu_torch.ckpt import load_checkpoint
from vision_collision_detection_tpu_torch.models.convert import (
    from_flax_params,
)
from vision_collision_detection_tpu_torch.parallel.tp import (
    rule_for,
    shard_rules,
    shard_state_dict,
)


def _jax_vivit():
    return JaxViViT(dim=384, spatial_layers=2, temporal_layers=1,
                    num_heads=6, patch_size=8, num_classes=3,
                    dtype=jnp.float32)


def _init(model):
    return jax.jit(lambda k, x: model.init(k, x, train=False))(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, 2, 16, 16, 3), jnp.float32))["params"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX TP step and the ranks' results."""
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    data = {"frames": (rng.random((8, 2, 16, 16, 3)) * 255).astype(np.uint8),
            "targets": (np.arange(8) % 3).astype(np.int64),
            "mask": np.ones(8, np.float32)}
    np.savez(tmp / "data.npz", **data)
    jmodel = _jax_vivit()
    # every leaf drawn (flax's initial biases are 0, so a bias fault would
    # not show)
    params = randomize_params(jax.device_get(_init(jmodel)),
                              np.random.default_rng(1))
    np.savez(tmp / "vivit.npz", **{k: v.numpy() for k, v in
                                    from_flax_params(params).items()})
    ranks = Ranks("tp", 2, tmp, tmp)

    cfg = JaxConfig().override({
        "model.dtype": "float32", "model.dropout": 0.0, "data.fps": 2,
        "data.duration": 1, "data.frame_size": 16, "augment.enabled": False,
        "augment.horizontal_flip_prob": 0.0, "augment.blur_sigma": 0.0})
    strategy = JaxTP(jax_mesh(JaxMeshConfig(num_data=1, num_model=2),
                              jax.devices()[:2]))
    state = strategy.shard_state(TrainState.create(
        apply_fn=jmodel.apply, params=params, batch_stats={},
        tx=optax.sgd(1e-3)))
    step, _ = strategy.make_steps(jmodel, cfg, None)
    sh = strategy.data_sharding
    s, m = step(state, *(jax.device_put(data[k], sh)
                         for k in ("frames", "targets", "mask")),
                jax.random.PRNGKey(3))
    ref = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "params": from_flax_params(jax.device_get(s.params))}
    ranks.wait(timeout=600)
    got = [torch.load(tmp / f"tp_r{r}.pt", weights_only=True)
           for r in range(2)]
    return ref, got, tmp, data


@pytest.mark.parametrize("n_model, heads", [(2, 6), (4, 6), (2, 4), (3, 6)])
def test_sharding_rules_match_jax(n_model, heads):
    """``shard_rules`` against the JAX ``param_shardings`` on the same
    model, kernel by weight: query/key/value and ``mlp_fc1`` cut their
    output rows, ``out`` and ``mlp_fc2`` their input columns, the rest
    whole; 6 heads over 4 ranks leave the attention whole and cut the
    MLP. The JAX rules keep every bias whole; the port cuts a
    column-parallel layer's bias with its rows."""
    dim = 384 if heads == 6 else 32
    jmodel = JaxViViT(dim=dim, spatial_layers=2, temporal_layers=1,
                      num_heads=heads, patch_size=8, num_classes=3,
                      dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: jmodel.init(
        k, jnp.zeros((1, 2, 16, 16, 3)), train=False),
        jax.random.PRNGKey(0))["params"]
    mesh = jax_mesh(JaxMeshConfig(num_data=8 // n_model if n_model != 3
                                  else 2, num_model=n_model),
                    jax.devices()[:8 if n_model != 3 else 6])
    specs = param_shardings(shapes, mesh)
    want = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(specs):
        names = [p.key for p in path]
        if names[-1] == "kernel" and any(a is not None for a in sh.spec):
            layer = names[-2]
            want[".".join(names[:-1] + ["weight"])] = (
                0 if layer in ("query", "key", "value", "mlp_fc1") else 1)
    from vision_collision_detection_tpu_torch.models.vivit import ViViT

    model = ViViT(num_patches=4, dim=dim, spatial_layers=2,
                  temporal_layers=1, num_heads=heads, patch_size=8,
                  num_classes=3, dtype=torch.float32)
    rules = shard_rules(model, n_model)
    assert {k: v for k, v in rules.items() if k.endswith("weight")} == want
    biases = {k for k in rules if k.endswith("bias")}
    assert all(k.replace("bias", "weight") in rules for k in biases)
    assert all(rules[k] == 0 for k in biases)
    if n_model == 4:
        assert "spatial_0.attn.query.weight" not in rules
        assert rules["spatial_0.mlp_fc1.weight"] == 0


def test_rule_for_by_name():
    assert rule_for("spatial_0.attn.query.weight", (384, 384), 2, 6) == 0
    assert rule_for("spatial_0.attn.value.bias", (384,), 2, 6) == 0
    assert rule_for("temporal_0.attn.out.weight", (384, 384), 2, 6) == 1
    assert rule_for("temporal_0.attn.out.bias", (384,), 2, 6) is None
    assert rule_for("spatial_1.mlp_fc1.bias", (1536,), 2, 6) == 0
    assert rule_for("spatial_1.mlp_fc2.weight", (384, 1536), 2, 6) == 1
    assert rule_for("spatial_1.mlp_fc2.bias", (384,), 2, 6) is None
    assert rule_for("spatial_0.norm1.weight", (384,), 2, 6) is None
    assert rule_for("spatial_0.attn.key.weight", (384, 384), 4, 6) is None
    assert rule_for("spatial_0.mlp_fc1.weight", (1536, 384), 4, 6) == 0
    assert rule_for("spatial_0.mlp_fc1.weight", (1536, 384), 5, 6) is None


def test_tp_step_matches_jax(run):
    """One TP step (SGD 1e-3) against the JAX ``ModelParallelStrategy``
    step: the loss (rel 1e-4), the global gradient norm (rel 1e-4), every
    parameter gathered (rtol 1e-4 / atol 1e-6, ``test_tp.py``'s for the
    query kernel); both ranks agree; the query weight is cut to 3 heads."""
    ref, (r0, r1), _, _ = run
    assert r0["local_query"] == (192, 384)
    assert r0["tp_metrics"] == r1["tp_metrics"]
    assert r0["tp_metrics"]["loss"] == pytest.approx(ref["loss"], rel=1e-4)
    assert r0["tp_metrics"]["grad_norm"] == pytest.approx(ref["grad_norm"],
                                                          rel=1e-4)
    got = r0["tp_params"]
    assert sorted(got) == sorted(ref["params"])
    for k, want in ref["params"].items():
        assert torch.equal(got[k], r1["tp_params"][k]), k
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_tp_eval_matches_one_device(run):
    """The TP evaluation after the step against one device with the
    gathered weights: probabilities (1e-5) and loss (rel 1e-5)."""
    _, (r0, r1), _, _ = run
    assert torch.equal(r0["tp_eval_probs"], r1["tp_eval_probs"])
    np.testing.assert_allclose(r0["tp_eval_probs"].sum(1).numpy(), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(r0["tp_eval_probs"].numpy(),
                               r0["single_eval_probs"].numpy(), atol=1e-5)
    assert r0["tp_eval_loss"] == pytest.approx(r0["single_eval_loss"],
                                               rel=1e-5)


def test_adamw_moments_live_on_local_shards(run):
    """``shard_state`` cuts AdamW's moments with their parameters (bit-equal
    to the cut of one device's moments; the step count whole); after a TP
    step each cut parameter's moments have its local shape, and
    ``full_state`` gathers them back to the full one."""
    _, (r0, _), _, _ = run
    assert r0["moments_cut_equal"]
    rules = r0["rules"]
    full = r0["gathered_moment_shapes"]
    for name, shape in r0["moment_shapes"].items():
        if name in rules:
            want = list(full[name])
            want[rules[name]] //= 2
            assert shape == tuple(want), name
        else:
            assert shape == full[name], name
    assert full["spatial_0.attn.query.weight"] == (384, 384)
    assert np.isfinite(r0["adamw_metrics"]["loss"])


def test_shard_then_gather_is_the_identity(run):
    """``full_state_dict(shard_state_dict(sd))`` is ``sd`` on both ranks;
    the two halves of each cut put back together give the whole."""
    _, (r0, r1), _, _ = run
    assert r0["roundtrip_equal"] and r1["roundtrip_equal"]
    sd = {k: torch.arange(v.numel(), dtype=torch.float32).reshape(v.shape)
          for k, v in r0["tp_params"].items()}
    rules = r0["rules"]
    halves = [shard_state_dict(sd, rules, i, 2) for i in range(2)]
    for k, dim in rules.items():
        assert torch.equal(torch.cat([h[k] for h in halves], dim), sd[k])


def test_tp_checkpoint_serves_on_one_device(run):
    """Rank 0 saved the gathered weights; a single-device model loaded from
    the checkpoint gives the TP forward (1e-5), also on the ``"flash"``
    blocks (K4 on 3 of the 6 heads a rank); the out projection's bias added
    on both ranks before the sum lands outside."""
    _, (r0, r1), tmp, data = run
    arrays, _ = load_checkpoint(str(tmp / "tp_run" / "best"))
    x = torch.from_numpy(data["frames"]).float() / 255.0
    outs = {}
    for impl in ("xla", "flash"):
        model = _tp_vivit(impl)
        model.load_state_dict(arrays["model"], strict=True)
        with torch.no_grad():
            outs[impl] = model.eval()(x)
    assert torch.equal(r0["tp_forward"], r1["tp_forward"])
    np.testing.assert_allclose(r0["tp_forward"].numpy(),
                               outs["xla"].numpy(), atol=1e-5)
    np.testing.assert_allclose(r0["tp_flash_forward"].numpy(),
                               outs["flash"].numpy(), atol=1e-5)
    err = float((r0["tp_forward_bias_fault"] - outs["xla"]).abs().max())
    assert err > 1e-3
