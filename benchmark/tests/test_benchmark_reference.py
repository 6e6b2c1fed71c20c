"""The plain reference against the program's CPU path, at small sizes on
seeded weights: K1, the training preprocess and its draws, the serving
forward of both configurations, and the first training steps through the
``Trainer`` (the program in float32 here, so that the two must agree to
float32's rounding)."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import harness, run, serve
from benchmark.reference import preprocess
from benchmark.reference.products import FLOAT32
from benchmark.reference.weights import make_params


def float32_cell(w: dict) -> dict:
    c = w["c"]
    c["compute_dtype"] = "float32"
    c["program"] = dict(c["program"], **{"model.dtype": "float32"})
    c["augment"]["affine_mode"] = "gather"  # the separable warp is bf16 by design
    return w


def test_k1_matches_the_program():
    from vision_collision_detection_tpu_torch.ops.dequant_pad import (
        dequant_normalize_pad_plain)

    g = torch.Generator().manual_seed(0)
    u8 = torch.randint(0, 256, (2, 3, 18, 32, 3), generator=g, dtype=torch.uint8)
    mean, std = (0.45, 0.45, 0.45), (0.225, 0.225, 0.225)
    want = dequant_normalize_pad_plain(u8, 32, mean, std, torch.float32)
    got = preprocess.eval_frames(u8, 32, mean, std)
    assert float((got - want).abs().max()) < 1e-5


@pytest.mark.parametrize("mode", ["gather", "separable"])
def test_training_preprocess_draws_as_the_program(mode, tiny_cell):
    from vision_collision_detection_tpu_torch.ops.preprocess import (
        train_preprocess)

    w = tiny_cell("flagship.train")
    cfg = harness.program_config(w["c"], **{"augment.affine_mode": mode})
    a = dict(w["c"]["augment"], affine_mode=mode)
    u8 = torch.from_numpy(harness.make_pool(w["c"], 3, 4, 7, "cpu"))
    want = train_preprocess(torch.Generator().manual_seed(5), u8, cfg.augment,
                            32, torch.float32)
    got = preprocess.train_frames(torch.Generator().manual_seed(5), u8, a, 32)
    # the separable warp multiplies bf16 operands in the program
    tol = 1e-5 if mode == "gather" else 0.1
    err = (got - want).abs()
    assert float(err.max()) < tol
    assert float(err.mean()) < (1e-6 if mode == "gather" else 5e-3)


@pytest.mark.parametrize("name", ["flagship.serve", "vivit_small.serve"])
def test_serving_forward_matches_the_program(name, tiny_cell):
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)

    w = float32_cell(tiny_cell(name))
    c = w["c"]
    cfg = harness.program_config(c)
    params = make_params(c, 3, "cpu")
    pred = CollisionPredictor(cfg, params, device="cpu")
    harness.check_sizes(c, pred.model, cfg)
    stride = pred._fold_stride()
    pool = harness.make_pool(c, 4, c["frames"] // stride, 4, "cpu")
    got = pred._make_forward(stride > 1)(torch.from_numpy(pool)).numpy()
    want = serve.reference_probs(c, params, pool, "cpu", FLOAT32)
    gap = np.abs(serve.centred_log(got) - serve.centred_log(want)).max()
    assert gap < 1e-3
    assert np.abs(got - want).max() < 1e-4
    # the logits spread: the comparison has something to compare
    assert serve.centred_log(want).std(axis=0).mean() > 0.1


@pytest.mark.parametrize("name", ["flagship.train", "vivit_small.train"])
def test_training_steps_match_the_program(name, tiny_cell):
    w = float32_cell(tiny_cell(name))
    rec = run.drive(w, 2 ** 40 + 7, 0.2, False, "cpu", time.perf_counter())
    n = dict(rec["diagnostics"], **rec["numbers"])
    assert n["loss_gap"] < 1e-4
    assert n["grad_gap"] < 1e-3
    assert n["change_gap"] < 1e-3
