"""The port's checkpoints: a true round trip of model, AdamW moments, step,
epoch, best metrics and history; roles, pruning and the fallback order
beside the JAX ``CheckpointStore`` on the same layout; the config contract
read back by the JAX package; ``from_checkpoint`` bit-equal to the
predictor that was saved."""

import json
import os

import numpy as np
import pytest
import torch

from vision_collision_detection_tpu.ckpt import CheckpointStore as JaxStore
from vision_collision_detection_tpu.config import ExperimentConfig as JaxConfig
from vision_collision_detection_tpu_torch.ckpt import (
    CheckpointStore,
    load_checkpoint,
)
from vision_collision_detection_tpu_torch.ckpt.checkpoint import (
    ARRAYS_FILE,
    META_FILE,
)
from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.infer.predictor import (
    CollisionPredictor,
)
from vision_collision_detection_tpu_torch.train.optim import build_optimizer

# a small ViViT (192 K parameters): what is held here does not depend on
# the architecture, and chip_smoke.py holds the flagship's on the card
OVERRIDES = {"model.backbone": "vivit_tiny", "model.patch_size": 14,
             "model.temporal_mode": "attention", "data.frame_size": 28,
             "data.fps": 1, "data.duration": 2}


def _small():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)}


def _trained(seed):
    """A small model after one AdamW step on seeded gradients."""
    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.LayerNorm(5))
    for p in model.parameters():
        p.data = torch.randn(p.shape, generator=g)
    opt, _ = build_optimizer(ExperimentConfig().optim, model.parameters(), 10)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    opt.step()
    return model, opt


def test_round_trip_resumes_model_optimizer_and_counters(tmp_path):
    model, opt = _trained(0)
    store = CheckpointStore(str(tmp_path / "run"))
    best = {"val_loss": 0.25, "auc": 0.875}
    history = [{"epoch": 0, "train_loss": 1.5}, {"epoch": 1, "train_loss": 1.0}]
    store.save("last", arrays={
        "model": model.state_dict(), "optimizer": opt.state_dict(),
        "step": 17, "epoch": 1, "best_metrics": best, "history": history,
    }, meta={"epoch": np.int64(1), "best_val_loss": np.float32(0.25),
             "class_weights": np.array([1.0, 2.0]), "names": ("a", "b")})
    arrays, meta = store.load("last")
    assert arrays["step"] == 17 and arrays["epoch"] == 1
    assert arrays["best_metrics"] == best and arrays["history"] == history
    assert meta == {"epoch": 1, "best_val_loss": 0.25,
                    "class_weights": [1.0, 2.0], "names": ["a", "b"]}
    sd = model.state_dict()
    assert all(torch.equal(arrays["model"][k], sd[k]) for k in sd)

    # resume: the same next step from the loaded moments as from the live ones
    resumed, ropt = _trained(1)
    resumed.load_state_dict(arrays["model"])
    ropt.load_state_dict(arrays["optimizer"])
    state = opt.state_dict()["state"]
    assert all(torch.equal(ropt.state_dict()["state"][i][k], state[i][k])
               for i in state for k in state[i])
    g = torch.Generator().manual_seed(5)
    grads = [torch.randn(p.shape, generator=g) for p in model.parameters()]
    for m, o in ((model, opt), (resumed, ropt)):
        for p, gr in zip(m.parameters(), grads):
            p.grad = gr.clone()
        o.step()
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), resumed.parameters()))


def test_numpy_leaves_round_trip(tmp_path):
    """The JAX trainer saves a numpy step: the store turns numpy arrays into
    tensors and numpy scalars into numbers, so what it saves loads."""
    store = CheckpointStore(str(tmp_path / "run"))
    store.save("last", arrays={
        "step": np.asarray(3), "x": np.float32(1.5),
        "nested": {"a": np.arange(4), "strided": np.arange(6)[::-2]},
        "model": {"w": torch.ones(2)}}, meta={})
    assert store.exists("last") and store.latest_role() == "last"
    arrays, _ = store.load("last")
    assert isinstance(arrays["step"], torch.Tensor)
    assert arrays["step"].shape == () and int(arrays["step"]) == 3
    assert arrays["x"] == 1.5 and type(arrays["x"]) is float
    assert torch.equal(arrays["nested"]["a"], torch.arange(4))
    assert torch.equal(arrays["nested"]["strided"], torch.tensor([5, 3, 1]))
    assert torch.equal(arrays["model"]["w"], torch.ones(2))


class _Opaque:
    pass


@pytest.mark.parametrize("leaf", [
    _Opaque(), np.array([{"a": 1}], dtype=object), {"deep": [1, _Opaque()]}],
    ids=["object", "object_array", "nested_object"])
def test_unloadable_leaf_is_refused_before_writing(tmp_path, leaf):
    store = CheckpointStore(str(tmp_path / "run"))
    with pytest.raises(TypeError, match="weights_only"):
        store.save("best", arrays={"model": _small(), "extra": leaf},
                   meta={"epoch": 0})
    assert not store.exists("best") and store.latest_role() is None
    assert os.listdir(store.run_dir) == []


def _layout(store):
    return sorted(os.listdir(store.run_dir))


def test_roles_pruning_and_fallback_as_jax(tmp_path):
    ours = CheckpointStore(str(tmp_path / "torch"), keep_epochs=2)
    ref = JaxStore(str(tmp_path / "jax"), keep_epochs=2)
    assert ours.latest_role() is ref.latest_role() is None
    steps = [("epoch", 0), ("epoch", 1), ("epoch", 2), ("epoch", 3),
             ("last", None), ("best", None)]
    for kind, e in steps:
        if kind == "epoch":
            ours.save_epoch(e, arrays=_small(), meta={"epoch": e})
            ref.save_epoch(e, arrays={"w": np.zeros(2)}, meta={"epoch": e})
        else:
            ours.save(kind, arrays=_small(), meta={})
            ref.save(kind, arrays={"w": np.zeros(2)}, meta={})
        assert _layout(ours) == _layout(ref)
        assert ours.latest_role() == ref.latest_role()
    assert _layout(ours) == ["best", "epoch_2", "epoch_3", "last"]
    assert ours.latest_role() == "best"
    for role in ("best", "last", "epoch_3"):
        assert ours.exists(role) and ref.exists(role)
    assert not ours.exists("epoch_0")
    assert sorted(os.listdir(ours.path("best"))) == [ARRAYS_FILE, META_FILE]


def test_meta_reads_back_through_the_jax_config(tmp_path):
    cfg = ExperimentConfig().override({
        "model.backbone": "convnext_base", "data.frame_size": 112,
        "data.class_names": ("a", "b", "c"), "optim.learning_rate": 3e-4,
        "augment.rotation_range": (-5.0, 5.0)})
    store = CheckpointStore(str(tmp_path / "run"))
    store.save("best", arrays=_small(), meta={"hyperparams": cfg.to_dict()})
    with open(os.path.join(store.path("best"), META_FILE)) as f:
        hp = json.load(f)["hyperparams"]
    back = JaxConfig.from_dict(hp)
    assert json.loads(back.to_json()) == json.loads(cfg.to_json())
    assert back.model.backbone == "convnext_base"
    assert ExperimentConfig.from_dict(hp) == cfg


def test_stale_tmp_never_shadows_a_role(tmp_path):
    store = CheckpointStore(str(tmp_path / "run"))
    for stale in ("best.tmp", "epoch_7.tmp"):
        os.makedirs(store.path(stale))
        with open(os.path.join(store.path(stale), ARRAYS_FILE), "w") as f:
            f.write("half a file")
    assert store.latest_role() is None and not store.exists("best")
    store.save_epoch(2, arrays=_small(), meta={"epoch": 2})
    assert store.latest_role() == "epoch_2"
    store.save("best", arrays={"w": torch.ones(2)}, meta={"epoch": 2})
    assert not os.path.exists(store.path("best.tmp"))
    arrays, meta = store.load("best")
    assert torch.equal(arrays["w"], torch.ones(2)) and meta == {"epoch": 2}
    assert os.path.isdir(store.path("epoch_7.tmp"))  # not a role, not pruned


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "nothing"))
    with pytest.raises(FileNotFoundError):
        CollisionPredictor.from_checkpoint(str(tmp_path / "nothing"),
                                           device="cpu")
    assert not os.path.exists(tmp_path / "nothing")
    CheckpointStore(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        CollisionPredictor.from_checkpoint(str(tmp_path / "empty"),
                                           device="cpu")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A predictor saved as ``best``; its probabilities on a batch."""
    cfg = ExperimentConfig().override(OVERRIDES)
    pred = CollisionPredictor(cfg, None, device="cpu")
    run = tmp_path_factory.mktemp("ckpt") / "run"
    store = CheckpointStore(str(run))
    store.save("best", arrays={"model": pred.model.state_dict()},
               meta={"hyperparams": cfg.to_dict()})
    frames = np.random.default_rng(3).integers(
        0, 256, (2, 2, 16, 28, 3), dtype=np.uint8)
    return run, pred._make_forward(False)(frames), frames


@pytest.mark.parametrize("where", ["run_dir", "role_dir"])
def test_from_checkpoint_is_bit_equal(saved, where):
    run, want, frames = saved
    path = str(run if where == "run_dir" else run / "best")
    pred = CollisionPredictor.from_checkpoint(path, device="cpu")
    assert pred.cfg == ExperimentConfig().override(OVERRIDES)
    got = pred._make_forward(False)(frames)
    assert torch.equal(got, want)


def test_from_checkpoint_needs_hyperparams_and_strict_weights(saved):
    run, _, _ = saved
    arrays, meta = load_checkpoint(str(run / "best"))
    store = CheckpointStore(str(run.parent / "bad"))
    store.save("best", arrays=arrays, meta={})
    with pytest.raises(ValueError, match="hyperparams"):
        CollisionPredictor.from_checkpoint(store.run_dir, device="cpu")
    # weights with a 3-class head under a contract that says 4 classes
    hp = dict(meta["hyperparams"])
    hp["model"] = dict(hp["model"], num_classes=4)
    hp["data"] = dict(hp["data"], num_classes=4,
                      class_names=["a", "b", "c", "d"])
    store.save("best", arrays=arrays, meta={"hyperparams": hp})
    with pytest.raises(RuntimeError, match="size mismatch|Missing"):
        CollisionPredictor.from_checkpoint(store.run_dir, device="cpu")
