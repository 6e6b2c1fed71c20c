"""The port's command line (``vision_collision_detection_tpu_torch/cli``)
against the JAX package's: the flags, the configuration they build, the
strategy choice, and each command run on the CPU (``--device cpu``) —
``train`` on synthetic clips (convnext_tiny + GRU at 32²), ``infer`` on its
run against the predictor, ``grid_search`` over two combinations, and
``convert_weights`` against the JAX command on the same ``.pth``."""

import argparse
import importlib
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_reference_import import _reference, _save
from torch_port_helpers import two_torch_threads  # noqa: F401
from vision_collision_detection_tpu_torch.cli import train as cli_train
from vision_collision_detection_tpu_torch.infer.predictor import (
    CollisionPredictor,
)
from vision_collision_detection_tpu_torch.models.import_torch import (
    load_manifest,
)
from vision_collision_detection_tpu_torch.train import SingleDeviceStrategy

COMMANDS = ("train", "infer", "grid_search", "convert_weights")
TRAIN_ARGS = ["--synthetic", "2", "--batch-size", "3", "--epochs", "1",
              "--frame-size", "32", "--fps", "6", "--duration", "2",
              "--num-workers", "2", "--experiment-name", "smoke",
              "--device", "cpu"]


class _Parsed(Exception):
    pass


def _parser(package, name, monkeypatch):
    """The argparse parser a CLI module's ``main`` builds: its
    ``build_parser``, or (the JAX ``convert_weights``, which has none) the
    parser ``main`` was about to parse with."""
    module = importlib.import_module(f"{package}.cli.{name}")
    if hasattr(module, "build_parser"):
        return module.build_parser()
    seen = []

    def capture(self, *args, **kwargs):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        module.main([])
    monkeypatch.undo()
    return seen[0]


def _flags(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", COMMANDS)
def test_parser_has_the_jax_flags(name, monkeypatch):
    """Every flag of the JAX command, with its option strings, default,
    choices, type, nargs and whether it is required; the port adds
    ``--device`` (default the card) and nothing else."""
    ours = _flags(_parser("vision_collision_detection_tpu_torch", name,
                          monkeypatch))
    theirs = _flags(_parser("vision_collision_detection_tpu", name,
                            monkeypatch))
    assert set(theirs) <= set(ours)
    extra = set(ours) - set(theirs)
    assert extra == (set() if name == "convert_weights" else {"device"})
    for dest, a in theirs.items():
        b = ours[dest]
        for attr in ("option_strings", "default", "choices", "type",
                     "nargs", "required", "const"):
            assert getattr(b, attr) == getattr(a, attr), (dest, attr)
        assert type(b) is type(a), dest
    if extra:
        assert ours["device"].default is None


@pytest.mark.parametrize("argv", [
    [],
    ["--fps", "5", "--duration", "3", "--frame-size", "112",
     "--sample-strategy", "uniform", "--load-sensor", "--backbone",
     "resnet18", "--temporal-mode", "lstm", "--dropout", "0.3", "--lr",
     "3e-4", "--weight-decay", "0", "--loss-type", "bce",
     "--no-class-weights", "--patience", "2", "--validation-freq", "1",
     "--seed", "7", "--no-augment", "--dashboard", "--save-dir", "out",
     "--experiment-name", "x", "--resume", "--epochs", "3",
     "--batch-size", "4", "--num-workers", "1", "--metadata-csv", "m.csv",
     "--pretrained-path", "w.npz"],
])
def test_config_from_args_matches_jax(argv):
    from vision_collision_detection_tpu.cli import train as jax_train

    ours = cli_train.config_from_args(cli_train.build_parser().parse_args(
        argv))
    theirs = jax_train.config_from_args(jax_train.build_parser().parse_args(
        argv))
    as_json = lambda cfg: json.loads(json.dumps(cfg.to_dict()))  # noqa: E731
    assert as_json(ours) == as_json(theirs)


def test_pick_strategy(monkeypatch):
    """One process: one device, unless ``--data-parallel`` asks for the
    data group, whose width ``VCD_NUM_DATA`` must not cut below the world
    (it raises rather than leave ranks out)."""
    parse = cli_train.build_parser().parse_args
    monkeypatch.delenv("VCD_NUM_DATA", raising=False)
    assert type(cli_train.pick_strategy(parse([]))) is SingleDeviceStrategy
    monkeypatch.setenv("VCD_NUM_DATA", "2")
    assert type(cli_train.pick_strategy(parse(["--single-device"]))) is \
        SingleDeviceStrategy
    with pytest.raises(ValueError, match="VCD_NUM_DATA=2"):
        cli_train.pick_strategy(parse(["--data-parallel"]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    save = str(tmp_path_factory.mktemp("cli") / "runs")
    assert cli_train.main(TRAIN_ARGS + ["--save-dir", save]) == 0
    yield save
    shutil.rmtree(save)  # three checkpoints of about 360 MB each


def test_train_writes_the_run(run):
    exp = os.path.join(run, "smoke")
    for role in ("best", "last"):
        assert os.path.isdir(os.path.join(exp, role)), role
    hist = pd.read_csv(os.path.join(exp, "training_history.csv"))
    assert len(hist) == 1 and "val_loss" in hist.columns
    assert np.isfinite(hist["val_loss"]).all()


def test_infer_equals_the_predictor(run, tmp_path, capsys):
    from vision_collision_detection_tpu_torch.cli.infer import main

    exp = os.path.join(run, "smoke")
    videos = os.path.join(run, "_synthetic_data", "videos")
    out_json, out_csv = str(tmp_path / "p.json"), str(tmp_path / "p.csv")
    assert main(["--checkpoint", exp, "--videos", videos, "--output",
                 out_json, "--csv", out_csv, "--device", "cpu"]) == 0
    pred = CollisionPredictor.from_checkpoint(exp, device="cpu")
    want = pred.predict(pred._collect_paths(videos))
    got = json.load(open(out_json))
    assert len(got) == 6 and got == want
    assert json.loads(capsys.readouterr().out) == want
    df = pd.read_csv(out_csv, float_precision="round_trip")
    assert list(df["id"]) == [r["id"] for r in want]
    np.testing.assert_array_equal(
        df["prob_collision"].to_numpy(),
        [r["probabilities"]["Collision"] for r in want])

    first = pred._collect_paths(videos)[0]
    assert main(["--checkpoint", exp, "--videos", first, "--sliding",
                 "--stride-sec", "0.5", "--output", out_json,
                 "--device", "cpu"]) == 0
    want = [dict(video_path=first, **r)
            for r in pred.predict_sliding(first, stride_sec=0.5)]
    assert json.load(open(out_json)) == want


def test_grid_search(tmp_path, capsys):
    from vision_collision_detection_tpu_torch.cli.grid_search import main

    save = str(tmp_path / "grid")
    assert main([
        "--synthetic", "2", "--save-dir", save, "--backbones", "resnet18",
        "--temporal-modes", "pooling", "--learning-rates", "1e-3", "3e-4",
        "--fps", "5", "--duration", "1", "--frame-size", "32",
        "--batch-size", "3", "--epochs", "1", "--validation-freq", "0",
        "--no-augment", "--single-device", "--num-workers", "2",
        "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(last)
    df = pd.read_csv(os.path.join(save, "grid_search_results.csv"))
    assert len(df) == 2 and list(df["best_val_loss"]) == sorted(
        df["best_val_loss"])
    assert out["best"]["experiment"] == df["experiment"][0]
    assert out["summary_csv"] == os.path.join(save,
                                              "grid_search_results.csv")
    assert os.path.exists(os.path.join(save, "grid_search.png"))
    shutil.rmtree(save)  # two runs' checkpoints


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_npz(a, b):
    a, b = _npz(a), _npz(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("backbone", ["convnext_tiny", "resnet18"])
def test_convert_weights_backbone_matches_jax(backbone, tmp_path):
    """A seeded state dict with the manifest's keys and shapes."""
    from vision_collision_detection_tpu.cli.convert_weights import (
        main as jax_main,
    )
    from vision_collision_detection_tpu_torch.cli.convert_weights import main

    g = torch.Generator().manual_seed(5)
    sd = {k: (torch.tensor(3) if k.endswith("num_batches_tracked")
              else torch.randn(shape, generator=g))
          for k, shape in load_manifest(backbone).items()}
    pth = str(tmp_path / "w.pth")
    torch.save(sd, pth)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    args = ["--torch-checkpoint", pth, "--backbone", backbone, "--output"]
    assert main(args + [ours]) == 0 and jax_main(args + [theirs]) == 0
    _assert_same_npz(ours, theirs)


def test_convert_weights_full_matches_jax(tmp_path):
    """The reference checkpoint of tests/test_torch_reference_import.py
    (convnext_tiny + GRU): the same arrays and the same sidecar."""
    from vision_collision_detection_tpu.cli.convert_weights import (
        main as jax_main,
    )
    from vision_collision_detection_tpu_torch.cli.convert_weights import main

    pth = _save(tmp_path, *_reference("convnext_tiny-gru"))
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    args = ["--torch-checkpoint", pth, "--full", "--output"]
    assert main(args + [ours]) == 0 and jax_main(args + [theirs]) == 0
    _assert_same_npz(ours, theirs)
    sidecar = lambda p: json.load(open(p + ".hyperparams.json"))  # noqa: E731
    assert sidecar(ours) == sidecar(theirs)
    with pytest.raises(SystemExit):
        main(["--torch-checkpoint", pth, "--output", ours])  # no --backbone
