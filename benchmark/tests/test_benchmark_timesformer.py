"""``timesformer_hr`` (``architectures/timesformer.py``,
``configs/timesformer_hr.json``): the configuration's published sizes and
work, K4's launch lists and bounds at its two shapes, and, at a small size
on the CPU, its serving cell (``timesformer_hr.serve``) and its training
under ``train_epochs`` (no cell: ``PERF.md`` §2 says why): a float32
program that agrees with the reference beside faults and the controls
that do not."""

from __future__ import annotations

import time

import pytest

from benchmark import counts, harness, run
from benchmark.architectures import timesformer
from benchmark.reference import weights

SEED = 2 ** 33 + 12345
SERVE, TRAIN = "timesformer_hr.serve", "timesformer_hr.train"


@pytest.fixture(scope="module")
def hr():
    return harness.cell(SERVE)["c"]


def test_the_published_sizes(hr):
    spec = weights.param_spec(hr)
    assert sum(weights._numel(s) for _, s, _ in spec) == 121_718_787
    assert len(spec) == 5 + 12 * 28 + 4
    assert timesformer.tokens(hr) + 1 == 785
    f, embed = timesformer.clip_flops(hr, False)
    assert f == pytest.approx(3.4054e12, rel=1e-4)
    assert embed == 2.0 * 16 * 784 * 768 * 768
    assert counts.clip_flops(hr, True) == 3 * f - embed


def test_k4_launches_and_bounds(hr):
    """One launch of each kernel at each shape a block; at B=8 the
    spatial forward is bound by its operations (0.245 ms), the temporal by
    its bytes (0.184 ms)."""
    fwd = timesformer.k4_launches(hr, 8, False)
    assert list(fwd) == ["fwd"] and len(fwd["fwd"]) == 24
    temporal, spatial = fwd["fwd"][:2]
    assert spatial.bound_s() == pytest.approx(spatial.ops / counts.BF16_FLOPS)
    assert spatial.bound_s() * 1e3 == pytest.approx(0.2450, abs=5e-5)
    assert temporal.bound_s() == pytest.approx(
        temporal.bytes / counts.HBM_BYTES_PER_S)
    assert temporal.bound_s() * 1e3 == pytest.approx(0.1840, abs=5e-5)
    train = timesformer.k4_launches(hr, 8, True)
    assert {k: len(v) for k, v in train.items()} == {
        "fwd": 24, "di": 24, "dkv": 24, "dq": 24}


def drive(w, fault=None):
    return run.drive(w, SEED, 0.3, False, "cpu", time.perf_counter(), fault)


def float32(w):
    """The program in float32 (the separable warp is bf16 by design: the
    gather warp), so that it and the reference agree to float32's
    rounding, far inside the limits."""
    c = w["c"]
    c["compute_dtype"] = "float32"
    c["program"] = dict(c["program"], **{"model.dtype": "float32"})
    c["augment"]["affine_mode"] = "gather"
    return w


def test_serving_answers_match_the_reference(tiny_cell):
    rec = drive(float32(tiny_cell(SERVE)))
    assert run.correct(rec), rec["numbers"]
    assert rec["numbers"]["logit_gap"] < 1e-3


def test_an_answer_altered_where_it_is_produced(tiny_cell, monkeypatch):
    from vision_collision_detection_tpu_torch.infer import predictor

    produce = predictor.ServingForward.forward

    def altered(self, frames):
        p = produce(self, frames).clone()
        p[0] = p[0].roll(1)
        return p

    monkeypatch.setattr(predictor.ServingForward, "forward", altered)
    rec = drive(tiny_cell(SERVE))
    assert not run.correct(rec), rec["numbers"]


def test_the_serving_control_is_not_correct(tiny_cell):
    from benchmark import control

    w = tiny_cell(SERVE)
    got = control.serve_control(w, SEED, "cpu")["control"]
    assert got["logit_gap"] > w["c"]["limits"]["serve"]["logit_gap"], got


def test_training_steps_match_the_program(tiny_cell):
    rec = drive(float32(tiny_cell(TRAIN)))
    n = dict(rec["diagnostics"], **rec["numbers"])
    assert run.correct(rec), rec["numbers"]
    assert n["loss_gap"] < 1e-4
    assert n["grad_gap"] < 1e-3
    assert n["change_gap"] < 1e-3


def test_a_step_that_returns_its_state_unchanged(tiny_cell):
    def frozen(stage, tr):
        tr.state.optimizer.step = lambda *a, **k: None

    rec = drive(tiny_cell(TRAIN), frozen)
    assert rec["numbers"]["change_gap"] == pytest.approx(1.0)
    assert not run.correct(rec)


def test_the_training_control_is_not_correct(tiny_cell):
    from benchmark import control

    w = tiny_cell(TRAIN)
    got = control.train_control(w, SEED, "cpu")["control"]
    limits = w["c"]["limits"]["train"]
    assert any(got[k] > lim for k, lim in limits.items()), got
