"""``correct`` comes out false when the timed path is broken underneath, and
true when it is not. Each test skips the look for a card and drives the
rest of a run (``run.drive``) on the CPU at a small size, with one fault
planted in the program, or with the control (the reference in fp8) put in
the program's place. One chip, so no fault of an exchange between chips."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness, run

SEED = 2 ** 33 + 12345


def drive(w, fault=None):
    return run.drive(w, SEED, 0.3, False, "cpu", time.perf_counter(), fault)


@pytest.mark.parametrize("name", ["flagship.serve", "vivit_small.serve",
                                  "flagship.train", "vivit_small.train"])
def test_a_sound_run_is_correct(name, tiny_cell):
    rec = drive(tiny_cell(name))
    assert run.correct(rec), rec["numbers"]


@pytest.mark.parametrize("name", ["flagship.serve", "vivit_small.serve"])
def test_an_answer_altered_where_it_is_produced(name, tiny_cell, monkeypatch):
    from vision_collision_detection_tpu_torch.infer import predictor

    produce = predictor.ServingForward.forward

    def altered(self, frames):
        p = produce(self, frames).clone()
        p[0] = p[0].roll(1)
        return p

    monkeypatch.setattr(predictor.ServingForward, "forward", altered)
    rec = drive(tiny_cell(name))
    assert not run.correct(rec), rec["numbers"]


@pytest.mark.parametrize("name", ["flagship.serve", "vivit_small.serve"])
def test_the_serving_control_is_not_correct(name, tiny_cell):
    from benchmark.reference import models
    from benchmark.reference.preprocess import eval_frames
    from benchmark.reference.products import Products
    from benchmark.reference.weights import make_params

    w = tiny_cell(name)
    c = w["c"]
    P = make_params(c, harness.seeds(SEED)["weights"], "cpu")
    a = c["augment"]

    @torch.no_grad()
    def reference_fp8(frames_u8):
        x = eval_frames(torch.as_tensor(frames_u8), c["frame_size"],
                        a["normalize_mean"], a["normalize_std"])
        return torch.softmax(models.logits(P, x, c, Products("fp8")), dim=-1)

    def in_its_place(stage, pred):
        pred._forward_cache[True] = pred._forward_cache[False] = reference_fp8

    rec = drive(w, in_its_place)
    assert not run.correct(rec), rec["numbers"]


@pytest.mark.parametrize("name", ["flagship.train", "vivit_small.train"])
def test_a_step_that_returns_its_state_unchanged(name, tiny_cell):
    def frozen(stage, tr):
        tr.state.optimizer.step = lambda *a, **k: None

    rec = drive(tiny_cell(name), frozen)
    assert rec["numbers"]["change_gap"] == pytest.approx(1.0)
    assert not run.correct(rec)


@pytest.mark.parametrize("name", ["flagship.train", "vivit_small.train"])
def test_half_of_the_batch_left_out(name, tiny_cell, monkeypatch):
    from vision_collision_detection_tpu_torch.train import steps

    loss = steps.weighted_loss

    def half(logits, targets, class_weights, sample_mask, **kw):
        keep = sample_mask.clone()
        keep[keep.shape[0] // 2:] = 0.0
        return loss(logits, targets, class_weights, keep, **kw)

    monkeypatch.setattr(steps, "weighted_loss", half)
    rec = drive(tiny_cell(name))
    assert not run.correct(rec), rec["numbers"]


@pytest.mark.parametrize("name", ["flagship.train", "vivit_small.train"])
def test_the_training_control_is_not_correct(name, tiny_cell):
    from benchmark import control

    w = tiny_cell(name)
    got = control.train_control(w, SEED, "cpu")["control"]
    limits = w["c"]["limits"]["train"]
    assert any(got[k] > lim for k, lim in limits.items()), got
