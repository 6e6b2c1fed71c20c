"""The port's ``Trainer`` against the JAX package's on the same splits, from
the same initial weights: convnext_tiny + GRU at 32², float32, the stock
block paths (K3's plain version rounds to bf16, so the port's fused MLP is
off, as in tests/test_torch_train.py), augmentation, flips, blur and
dropout off, class weights on, one clip that does not decode in the
training set. Two epochs: the batches, the per-epoch losses and the
artifacts; a run without class weights and a run that ignores the mask must
land outside the tolerance. After the JAX package's
``tests/test_learning.py``."""

import json
import os
import shutil

import jax
import numpy as np
import pandas as pd
import pytest

from torch_port_helpers import two_torch_threads  # noqa: F401
from vision_collision_detection_tpu.config import ExperimentConfig as JaxConfig
from vision_collision_detection_tpu.data import (
    ClipRecord as JaxRecord,
    create_datasets_with_manual_split as jax_splits,
)
from vision_collision_detection_tpu.train import Trainer as JaxTrainer
from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.data import (
    ClipRecord,
    create_datasets_with_manual_split,
)
from vision_collision_detection_tpu_torch.media.synthetic import (
    generate_dataset,
)
from vision_collision_detection_tpu_torch.models.backbones import convnext
from vision_collision_detection_tpu_torch.models.convert import (
    load_flax_params,
)
from vision_collision_detection_tpu_torch.train import Trainer
from vision_collision_detection_tpu_torch.train import trainer as trainer_mod

OVERRIDES = {
    "model.dtype": "float32", "model.dropout": 0.0,
    "data.fps": 5, "data.duration": 1, "data.frame_size": 32,
    "data.batch_size": 6, "data.num_workers": 2,
    "optim.learning_rate": 3e-4,
    "train.epochs": 2, "train.patience": 2, "train.validation_freq": 0,
    "train.log_every_steps": 0, "train.checkpoint_every_epochs": 0,
    "augment.enabled": False, "augment.horizontal_flip_prob": 0.0,
    "augment.blur_sigma": 0.0,
}
# Per-epoch train and validation loss, relative. The two packages run the
# same float32 model on the same batches; their convolutions and products
# sum in other orders, and six AdamW steps carry that rounding forward
# (measured 9.0e-7).
LOSS_TOL = 1e-4
BROKEN = "/nonexistent_clip.mp4"


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """8 clips a class (17 decodable training clips and one that does not
    decode, so each epoch's three batches of 6 hold it; 3 val, 3 test), as
    datasets of both packages."""
    root = tmp_path_factory.mktemp("parity")
    df = pd.read_csv(generate_dataset(
        str(root), clips_per_class=8, num_frames=10, height=48, width=64,
        splits=("train",) * 6 + ("val", "test"),
    )).fillna({"sensor_path": ""})
    kw = dict(fps=5, duration=1, frame_size=32)
    ours, ref = create_datasets_with_manual_split(df, **kw), jax_splits(df, **kw)
    for train, record in ((ours[0], ClipRecord), (ref[0], JaxRecord)):
        train.records = train.records[:-1] + [record("broken", BROKEN, 1)]
    return ours, ref


@pytest.fixture(scope="module")
def runs(splits, tmp_path_factory):
    """Both trainers from the JAX trainer's initial parameters, trained 2
    epochs and tested."""
    (train, val, test), (jtrain, jval, jtest) = splits
    root = tmp_path_factory.mktemp("runs")
    jtr = JaxTrainer(JaxConfig().override(OVERRIDES), jtrain, jval, jtest,
                     run_dir=str(root / "jax"))
    init = jax.device_get(jtr.state.params)
    mp = pytest.MonkeyPatch()
    mp.setattr(convnext, "FUSED_MLP_DEFAULT", False)
    try:
        tr = _port_trainer(train, val, test, init, str(root / "port"))
    finally:
        mp.undo()
    ids = {name: _batch_ids(loader)
           for name, loader in (("port_train", tr.train_loader),
                                ("jax_train", jtr.train_loader),
                                ("port_val", tr.val_loader),
                                ("jax_val", jtr.val_loader))}
    jhist, hist = jtr.train(), tr.train()
    yield {"jax": jtr, "port": tr, "init": init, "ids": ids,
           "jax_test": jtr.test(), "port_test": tr.test(),
           "jax_hist": jhist.to_dataframe(), "hist": hist.to_dataframe()}
    # a checkpoint with its optimizer moments takes about 360 MB
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _batch_ids(loader):
    """The ids of each batch the loader gives in epochs 0 and 1."""
    ids = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        ids += [batch["id"] for batch in loader]
    loader.set_epoch(0)
    return ids


def _port_trainer(train, val, test, init, run_dir, **over):
    cfg = ExperimentConfig().override(dict(OVERRIDES, **over))
    tr = Trainer(cfg, train, val, test, run_dir=run_dir, device="cpu")
    load_flax_params(tr.model, init)
    return tr


def test_same_batches_in_the_same_order(runs):
    ids = runs["ids"]
    assert ids["port_train"] == ids["jax_train"]
    assert ids["port_val"] == ids["jax_val"]
    assert len(ids["port_train"]) == 6  # 3 batches in each of 2 epochs
    assert all(any("broken" in b for b in ids["port_train"][e:e + 3])
               for e in (0, 3))


def test_losses_track_jax(runs):
    hist, jhist = runs["hist"], runs["jax_hist"]
    assert list(hist.columns) == list(jhist.columns)
    for col in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[col], jhist[col], rtol=LOSS_TOL,
                                   err_msg=col)
    np.testing.assert_allclose(hist["learning_rate"], jhist["learning_rate"],
                               rtol=1e-6)
    assert runs["port"].state.step == int(runs["jax"].state.step) == 6
    # the loss falls either way; the JAX package's learning threshold was
    # set for resnet18 over 6 epochs and is not held here
    assert hist["train_loss"].iloc[-1] < hist["train_loss"].iloc[0]


def _epoch0_loss(splits, runs, tmp_path, **over):
    (train, val, _), _ = splits
    mp = pytest.MonkeyPatch()
    mp.setattr(convnext, "FUSED_MLP_DEFAULT", False)
    try:
        tr = _port_trainer(train, val, None, runs["init"], str(tmp_path),
                           **over)
    finally:
        mp.undo()
    return tr.train(epochs=1).records[0]["train_loss"]


def test_dropped_class_weights_land_outside(splits, runs, tmp_path):
    loss = _epoch0_loss(splits, runs, tmp_path,
                        **{"optim.use_class_weights": False})
    want = runs["jax_hist"]["train_loss"].iloc[0]
    assert abs(loss - want) / want > 10 * LOSS_TOL, (loss, want)


def test_ignored_mask_lands_outside(splits, runs, tmp_path, monkeypatch):
    def unmasked(loader):
        for batch in loader:
            yield dict(batch, mask=np.ones(len(batch["id"]), np.float32))

    monkeypatch.setattr(trainer_mod, "_with_mask", unmasked)
    loss = _epoch0_loss(splits, runs, tmp_path)
    want = runs["jax_hist"]["train_loss"].iloc[0]
    assert abs(loss - want) / want > 10 * LOSS_TOL, (loss, want)


def _csv(run_dir, name):
    return pd.read_csv(os.path.join(run_dir, name))


def test_artifacts_equal_jax(runs):
    """The same files with the same content: columns, ids, epochs and
    counts exactly, numbers within the tolerance."""
    ours, ref = runs["port"].run_dir, runs["jax"].run_dir
    for name in ("training_history.csv", "test_predictions.csv"):
        got, want = _csv(ours, name), _csv(ref, name)
        assert list(got.columns) == list(want.columns), name
        for col in got.columns:
            if col == "epoch_time_sec":
                continue
            if got[col].dtype.kind == "f":
                np.testing.assert_allclose(got[col], want[col], rtol=1e-3,
                                           atol=1e-4, err_msg=f"{name} {col}")
            else:
                assert got[col].tolist() == want[col].tolist(), (name, col)
    for epoch in (0, 1):
        with open(os.path.join(ours, f"validation_epoch{epoch}.json")) as f:
            got = json.load(f)
        with open(os.path.join(ref, f"validation_epoch{epoch}.json")) as f:
            want = json.load(f)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if k == "eval_time_sec":
                continue
            if isinstance(v, float):
                assert got[k] == pytest.approx(v, rel=1e-3, abs=1e-4), k
            else:
                assert got[k] == v, k
    pt, jt = runs["port_test"], runs["jax_test"]
    assert pt["ids"] == jt["ids"] and pt["num_samples"] == jt["num_samples"]
    np.testing.assert_allclose(pt["_probs"], jt["_probs"], atol=1e-4)
    assert pt["loss"] == pytest.approx(jt["loss"], rel=LOSS_TOL)
    for role in ("best", "last", "epoch_0"):
        assert runs["port"].store.exists(role) == \
            runs["jax"].store.exists(role), role


def test_model_learns_synthetic_signal(splits, tmp_path):
    """The JAX package's learning check, held for convnext_tiny + GRU: 6
    epochs on the synthetic classes (dropout 0.1, no augmentation) take
    the training accuracy well above chance (the port read 1.0 from the
    third epoch on, against the 0.6 asked)."""
    (train, val, _), _ = splits
    cfg = ExperimentConfig().override(dict(OVERRIDES, **{
        "model.dropout": 0.1, "train.epochs": 6, "train.patience": 6}))
    hist = Trainer(cfg, train, val, run_dir=str(tmp_path / "learn"),
                   device="cpu").train().records
    assert hist[-1]["train_accuracy"] > 0.6, [r["train_accuracy"]
                                              for r in hist]
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
