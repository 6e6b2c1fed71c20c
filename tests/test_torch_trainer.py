"""The port's training engine on the CPU: a run end to end with its
artifacts, the mini-validation cascade, resume (and what it must restore),
the notebook entry, corrupt clips, early stopping and a run with the
sensor branch, at convnext_tiny + GRU on 32² frames, after the JAX
package's ``tests/test_train.py``, ``test_learning.py`` and
``test_sensor_fusion.py``."""

import copy
import csv
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from torch_port_helpers import two_torch_threads  # noqa: F401
from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.data import (
    ClipRecord,
    create_datasets_with_manual_split,
)
from vision_collision_detection_tpu_torch.infer.predictor import (
    CollisionPredictor,
)
from vision_collision_detection_tpu_torch.media.synthetic import (
    generate_dataset,
)
from vision_collision_detection_tpu_torch.train import (
    SingleDeviceStrategy,
    Trainer,
)
from vision_collision_detection_tpu_torch.train import trainer as trainer_mod

CLASS_COLUMNS = ("prob_normal", "prob_near_collision", "prob_collision")


def tiny_config(**over):
    return ExperimentConfig().override({
        "model.dtype": "float32",
        "data.fps": 5, "data.duration": 1, "data.frame_size": 32,
        "data.batch_size": 3, "data.num_workers": 2,
        "train.epochs": 2, "train.validation_freq": 0,
        "train.log_every_steps": 0, "train.checkpoint_every_epochs": 0,
        "optim.learning_rate": 1e-3, "augment.blur_sigma": 0.0,
        **over,
    })


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """A checkpoint of convnext_tiny with its AdamW moments takes about
    360 MB: each test's directory goes when the test ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def synth_splits(tmp_path_factory):
    """4 clips a class: 6 train, 3 val, 3 test."""
    root = tmp_path_factory.mktemp("trainer_synth")
    csv_path = generate_dataset(
        str(root), clips_per_class=4, num_frames=12, height=40, width=56,
        splits=("train", "train", "val", "test"),
    )
    return pd.read_csv(csv_path).fillna({"sensor_path": ""})


def _splits(df, **kw):
    return create_datasets_with_manual_split(
        df, fps=5, duration=1, frame_size=32, **kw)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def finished_run(synth_splits, tmp_path_factory):
    """Two epochs with a checkpoint each epoch (the newest kept), then
    ``test()``."""
    train, val, test = _splits(synth_splits)
    root = tmp_path_factory.mktemp("run")
    run_dir = str(root / "run")
    cfg = tiny_config(**{"train.checkpoint_every_epochs": 1,
                         "train.keep_checkpoints": 1})
    tr = Trainer(cfg, train, val, test, run_dir=run_dir, device="cpu")
    hist = tr.train()
    yield tr, hist, tr.test(), run_dir
    shutil.rmtree(root, ignore_errors=True)


def test_train_validate_test_and_artifacts(finished_run):
    tr, hist, res, run_dir = finished_run
    assert tr.device == torch.device("cpu")
    assert tr.steps_per_epoch == 2 and tr.state.step == 4
    assert [r["epoch"] for r in hist.records] == [0, 1]
    for name in ("training_history.csv", "validation_epoch0.json",
                 "validation_epoch1.json", "test_results.json",
                 "test_predictions.csv", "training.log"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    for role in ("best", "last", "epoch_1"):
        assert tr.store.exists(role), role
    assert not os.path.exists(tr.store.path("epoch_0"))  # pruned to 1
    rows = _read_csv(os.path.join(run_dir, "training_history.csv"))
    assert [int(r["epoch"]) for r in rows] == [0, 1]
    assert all(np.isfinite(float(r["train_loss"])) for r in rows)
    assert {"val_loss", "val_auc", "learning_rate",
            "val_precision_near_collision"} <= set(rows[0])
    with open(os.path.join(run_dir, "validation_epoch1.json")) as f:
        val = json.load(f)
    assert val["num_samples"] == 3 and "ids" not in val and "_probs" not in val

    assert res["num_samples"] == 3
    preds = _read_csv(os.path.join(run_dir, "test_predictions.csv"))
    assert list(preds[0]) == ["id", "target", "predicted", *CLASS_COLUMNS,
                              "correct"]
    assert [p["id"] for p in preds] == res["ids"]
    for p, probs in zip(preds, res["_probs"]):
        np.testing.assert_allclose([float(p[c]) for c in CLASS_COLUMNS],
                                   probs, rtol=1e-6)
        assert p["correct"] == str(p["target"] == p["predicted"])
    with open(os.path.join(run_dir, "test_results.json")) as f:
        assert json.load(f)["num_samples"] == 3


def test_checkpoint_serves_the_test_probabilities(finished_run, synth_splits):
    """``from_checkpoint`` on the run directory loads ``best`` (what
    ``test()`` scored) and gives the probabilities ``test()`` recorded."""
    tr, _, res, run_dir = finished_run
    assert tr.store.latest_role() == "best"
    arrays, meta = tr.store.load("best")
    assert set(arrays) == {"model", "optimizer", "step"}
    assert isinstance(arrays["step"], int)
    assert meta["hyperparams"] == json.loads(tr.cfg.to_json())
    pred = CollisionPredictor.from_checkpoint(run_dir, device="cpu")
    batch = next(iter(tr.test_loader))
    probs = pred._make_forward(False)(batch["frames"])
    assert torch.equal(probs, torch.from_numpy(res["_probs"]))


def test_mini_val_cascade_updates_dashboard(synth_splits, tmp_path):
    """The cascade renders the mini-validation and, on improvement, the
    full validation on the dashboard."""
    train, val, _ = _splits(synth_splits)
    tr = Trainer(tiny_config(), train, val, run_dir=str(tmp_path / "viz"),
                 device="cpu")
    calls = {"mini": [], "full": []}

    class _Recorder:
        def update_val_metrics(self, m):
            calls["mini"].append(m)

        def update_full_val_metrics(self, m):
            calls["full"].append(m)

    tr._viz = _Recorder()
    tr._mini_validate_cascade(epoch=0)
    assert len(calls["mini"]) == 1 and "loss" in calls["mini"][0]
    # a fresh trainer's best mini loss is inf: the full validation runs
    assert len(calls["full"]) == 1
    assert tr.store.exists("best")  # its loss beat inf too
    tr._mini_validate_cascade(epoch=0)  # the same mini loss: no full run
    assert len(calls["mini"]) == 2 and len(calls["full"]) == 1


def test_cascade_runs_inside_the_epoch(synth_splits, tmp_path):
    """``validation_freq`` 2 with 2 steps an epoch: a mini-validation after
    each step, the dashboard on, the first step profiled."""
    train, val, _ = _splits(synth_splits)
    cfg = tiny_config(**{"train.validation_freq": 2, "train.epochs": 1,
                         "train.mini_val_batches": 1, "train.dashboard": True,
                         "train.log_every_steps": 1, "train.profile_steps": 1})
    tr = Trainer(cfg, train, val, run_dir=str(tmp_path / "cascade"),
                 device="cpu")
    seen = []
    cascade = tr._mini_validate_cascade
    tr._mini_validate_cascade = lambda epoch: (seen.append(tr.state.step),
                                               cascade(epoch))
    tr.train()
    assert seen == [1, 2]
    assert os.path.exists(os.path.join(tr.run_dir, "dashboard.html"))
    assert tr.best_mini_loss < float("inf")
    with open(os.path.join(tr.run_dir, "profile", "trace.json")) as f:
        assert json.load(f)["traceEvents"]


def _last_model(run_dir):
    arrays, meta = trainer_mod.CheckpointStore(run_dir).load("last")
    return arrays, meta


@pytest.fixture(scope="module")
def one_epoch(synth_splits, tmp_path_factory):
    """The first epoch of ``finished_run``'s training alone: its trainer
    and its ``last`` checkpoint, which each resume below copies."""
    train, val, _ = _splits(synth_splits)
    root = tmp_path_factory.mktemp("one_epoch")
    tr = Trainer(tiny_config(), train, val, run_dir=str(root / "run"),
                 device="cpu")
    tr.train(epochs=1)
    yield tr
    shutil.rmtree(root, ignore_errors=True)


def _resumed_from(one_epoch, run_dir):
    """A resuming trainer in ``run_dir``, which holds a copy of
    ``one_epoch``'s ``last``."""
    shutil.copytree(one_epoch.store.path("last"),
                    os.path.join(run_dir, "last"))
    train, val = one_epoch.train_loader.dataset, one_epoch.val_loader.dataset
    return Trainer(tiny_config(**{"train.resume": True}), train, val,
                   run_dir=run_dir, device="cpu")


def test_resume_restores_step_moments_and_history(finished_run, one_epoch,
                                                  tmp_path):
    arrays, _ = _last_model(one_epoch.run_dir)
    tr2 = _resumed_from(one_epoch, str(tmp_path / "resume"))
    assert tr2.start_epoch == 1 and tr2.state.step == 2 == arrays["step"]
    assert tr2.history.records == one_epoch.history.records
    assert tr2.best_val_loss == one_epoch.best_val_loss
    moments = tr2.state.optimizer.state_dict()["state"]
    saved = arrays["optimizer"]["state"]
    assert moments.keys() == saved.keys() and len(moments) > 0
    for i in saved:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(moments[i][k], saved[i][k])
    tr2.train(epochs=2)
    assert tr2.state.step == 4
    assert [r["epoch"] for r in tr2.history.records] == [0, 1]

    # the resumed run equals the uninterrupted one (finished_run, 2 epochs)
    whole, _, _, whole_dir = finished_run
    got, _ = _last_model(tr2.run_dir)
    want, _ = _last_model(whole_dir)
    assert got["step"] == want["step"]
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert [r["train_loss"] for r in tr2.history.records] == \
        [r["train_loss"] for r in whole.history.records]


@pytest.mark.parametrize("fault", ["moments_dropped", "step_restarted"])
def test_resume_faults_land_outside(finished_run, one_epoch, tmp_path,
                                    monkeypatch, fault):
    """A resume that drops the AdamW moments, or restarts ``step`` at 0,
    does not reproduce the uninterrupted run."""
    restore = Trainer._restore_arrays

    def faulty(self, arrays):
        if fault == "moments_dropped":
            arrays = dict(arrays, optimizer={
                "state": {}, "param_groups":
                    arrays["optimizer"]["param_groups"]})
        else:
            arrays = dict(arrays, step=0)
        restore(self, arrays)

    monkeypatch.setattr(Trainer, "_restore_arrays", faulty)
    tr = _resumed_from(one_epoch, str(tmp_path / "fault"))
    tr.train(epochs=2)
    got, _ = _last_model(tr.run_dir)
    want, _ = _last_model(finished_run[3])
    diff = max(float((got["model"][k] - v).abs().max())
               for k, v in want["model"].items())
    assert diff > 1e-4, diff


def test_early_stopping_after_patience(synth_splits, tmp_path, monkeypatch):
    """A validation loss that stops improving ends the run after
    ``patience`` epochs; ``best`` keeps the epoch that was best. (The
    epochs' steps and validations are stubbed: the rule is the loop's.)"""
    train, val, _ = _splits(synth_splits)
    losses = iter([1.0, 0.5, 0.7, 0.6, 0.9, 0.1])
    monkeypatch.setattr(Trainer, "_train_epoch",
                        lambda self, epoch: {"loss": 1.0, "accuracy": 0.5})
    monkeypatch.setattr(Trainer, "evaluate",
                        lambda self, loader, max_batches=None, epoch=0:
                        {"loss": next(losses), "num_samples": 3})
    tr = Trainer(tiny_config(**{"train.epochs": 6, "train.patience": 2}),
                 train, val, run_dir=str(tmp_path / "stop"), device="cpu")
    hist = tr.train()
    assert [r["epoch"] for r in hist.records] == [0, 1, 2, 3]
    assert tr.best_val_loss == 0.5
    assert tr.store.load("best")[1]["epoch"] == 1


def test_step_generator_seeds_are_per_step_and_rank():
    seeds = {trainer_mod.step_seed(42, e, s, r)
             for e in range(3) for s in range(4) for r in range(2)}
    assert len(seeds) == 24
    assert trainer_mod.step_seed(42, 1, 2) == trainer_mod.step_seed(42, 1, 2)


def test_device_defaults_to_the_card(synth_splits, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train, val, _ = _splits(synth_splits)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tiny_config(), train, val, run_dir=str(tmp_path / "r"))


def test_run_notebook_equivalent_smoke(tmp_path):
    from vision_collision_detection_tpu_torch.train import (
        run_notebook_equivalent,
    )

    csv_path = generate_dataset(
        str(tmp_path / "clips"), clips_per_class=3, num_frames=6, height=40,
        width=56, fps=3, splits=("train", "val", "test"),
    )
    trainer, history, test_results = run_notebook_equivalent(
        csv_path,
        save_dir=str(tmp_path / "results"),
        experiment_name="nb_smoke",
        epochs=1,
        batch_size=2,
        use_dashboard=False,
        config_overrides={
            "model.dtype": "float32",
            "data.fps": 3, "data.duration": 2, "data.frame_size": 32,
            "train.validation_freq": 0, "train.log_every_steps": 0,
            "augment.enabled": False, "augment.blur_sigma": 0.0,
            "augment.horizontal_flip_prob": 0.0,
        },
        device="cpu",
    )
    assert trainer.cfg.model.backbone == "convnext_tiny"
    assert trainer.cfg.model.temporal_mode == "gru"
    assert trainer.cfg.optim.learning_rate == 1e-4
    assert trainer.cfg.optim.weight_decay == 1e-4
    assert trainer.cfg.optim.use_class_weights is True
    assert trainer.cfg.data.sample_strategy == "center"
    assert trainer.run_dir == str(tmp_path / "results" / "nb_smoke")
    assert len(history.records) == 1
    assert "accuracy" in test_results


def test_training_survives_corrupt_clips(synth_splits, tmp_path):
    train, val, _ = _splits(synth_splits)
    train2 = copy.copy(train)
    train2.records = list(train.records) + [
        ClipRecord("broken1", "/nonexistent_a.mp4", 0),
        ClipRecord("broken2", "/nonexistent_b.mp4", 2),
    ]
    cfg = tiny_config(**{"data.batch_size": 4, "train.epochs": 1,
                         "data.content_box_transfer": False})
    tr = Trainer(cfg, train2, val, run_dir=str(tmp_path / "corrupt"),
                 device="cpu")
    hist = tr.train()
    assert np.isfinite(hist.records[-1]["train_loss"])


def test_trainer_with_sensor_fusion(tmp_path):
    csv_path = generate_dataset(
        str(tmp_path / "synth"), clips_per_class=2, num_frames=8, height=40,
        width=56, splits=("train", "val"),
    )
    df = pd.read_csv(csv_path).fillna({"sensor_path": ""})
    train, val, _ = create_datasets_with_manual_split(
        df, fps=4, duration=2, frame_size=32, load_sensor=True)
    cfg = tiny_config(**{
        "model.use_sensor": True, "model.frame_subsample": 1,
        "data.fps": 4, "data.duration": 2, "data.load_sensor_data": True,
        "train.epochs": 1})
    tr = Trainer(cfg, train, val, run_dir=str(tmp_path / "run"),
                 device="cpu")
    before = {k: v.clone() for k, v in tr.model.state_dict().items()
              if k.startswith("sensor_fc")}
    hist = tr.train()
    assert np.isfinite(hist.records[-1]["train_loss"])
    assert set(before) == {"sensor_fc1.weight", "sensor_fc1.bias",
                           "sensor_fc2.weight", "sensor_fc2.bias"}
    arrays, _ = tr.store.load("last")
    for k, v in before.items():
        assert not torch.equal(arrays["model"][k], v), k


def test_strategy_is_the_single_device_one(finished_run):
    tr = finished_run[0]
    assert isinstance(tr.strategy, SingleDeviceStrategy)
    assert tr.strategy.is_main and tr.strategy.num_data_shards == 1
    ids = ["clip_a", "ünï", ""]
    assert trainer_mod._bytes_to_ids(trainer_mod._ids_to_bytes(ids)) == ids
