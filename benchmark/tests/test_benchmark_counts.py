"""The yardstick's counts against hand counts at the flagship's and the
ViViT's shapes (B = 8)."""

from __future__ import annotations

import pytest

from benchmark import counts, harness
from benchmark.architectures import convnext_gru
from benchmark.architectures import vivit as vivit_arch


@pytest.fixture(scope="module")
def flagship():
    return harness.cell("flagship.serve")["c"]


@pytest.fixture(scope="module")
def vivit():
    return harness.cell("vivit_small.serve")["c"]


def test_bound_takes_the_larger_side():
    assert counts.bound_s(3.35e12, 0, 1) == pytest.approx(1.0)
    assert counts.bound_s(0, 989e12, counts.BF16_FLOPS) == pytest.approx(1.0)
    assert counts.bound_s(3.35e9, 989e12, counts.BF16_FLOPS) == pytest.approx(1.0)


def test_convnext_tiny_is_four_and_a_half_giga_macs_a_frame(flagship):
    stages = convnext_gru.stages(flagship)
    assert stages == [(56, 96, 3), (28, 192, 3), (14, 384, 9), (7, 768, 3)]
    f, stem = convnext_gru.clip_flops(flagship, train=False)
    T = convnext_gru.frames_in_backbone(flagship, train=False)
    assert T == 25
    backbone_macs = (f - stem) / T / 2 + stem / T / 2
    # ConvNeXt-T: the published 4.5 G multiply-adds at 224² (heads aside)
    assert backbone_macs == pytest.approx(4.45e9, rel=0.02)
    assert stem / T == pytest.approx(2 * 56 * 56 * 96 * 48)


def test_k2_forward_counts(flagship):
    launches = convnext_gru.k2_launches(flagship, 8, train=False)
    assert len(launches) == 18
    ops = sum(x.ops for x in launches)
    assert ops == pytest.approx(98 * 200 * 2_145_024)  # ≈ 42 GFLOP
    assert sum(x.bound_s() for x in launches) * 1e3 == pytest.approx(0.627, abs=2e-3)
    assert len(convnext_gru.k2_launches(flagship, 8, train=True)) == 36
    assert len(convnext_gru.k2_wgrad_launches(flagship, 8)) == 18


def test_k3_counts(flagship):
    ev = convnext_gru.k3_launches(flagship, 8, train=False)
    assert len(ev) == 18
    assert sum(x.ops for x in ev) == pytest.approx(1.665e12, rel=1e-3)
    # operations bind every stage but the first, where x, y and out's bytes do
    assert sum(x.bound_s() for x in ev) * 1e3 == pytest.approx(1.726, abs=2e-3)
    tr = convnext_gru.k3_launches(flagship, 8, train=True)
    assert sum(x.bound_s() for x in tr) * 1e3 == pytest.approx(2.579, abs=3e-3)


def test_k4_counts(vivit):
    fwd = vivit_arch.k4_launches(vivit, 8, train=False)
    assert len(fwd) == 8
    # [256, 576, 6, 64]: bytes bind the forward at S = 576
    assert fwd[0].bytes / counts.HBM_BYTES_PER_S > fwd[0].ops / counts.BF16_FLOPS
    assert sum(x.bound_s() for x in fwd) * 1e3 == pytest.approx(1.082, abs=3e-3)
    tr = vivit_arch.k4_launches(vivit, 8, train=True)
    assert len(tr) == 32
    dkv, dq = tr[16:24], tr[24:]
    assert sum(x.bound_s() for x in dkv) * 1e3 == pytest.approx(2.111, abs=3e-3)
    assert sum(x.bound_s() for x in dq) * 1e3 == pytest.approx(1.583, abs=3e-3)


def test_vivit_forward_flops(vivit):
    f, embed = vivit_arch.clip_flops(vivit, train=False)
    assert 8 * f == pytest.approx(5.3e12, rel=0.05)
    assert embed == pytest.approx(2 * 32 * 576 * 588 * 384)


def test_training_counts_twice_the_forward_for_the_backward(flagship, vivit):
    for c in (flagship, vivit):
        f = counts.clip_flops(c, train=False)
        tr = counts.clip_flops(c, train=True)
        if c["architecture"] == "vivit":
            assert 2.9 * f < tr < 3 * f
    # the flagship folds in the model when training: 25 of its 50 frames
    assert convnext_gru.frames_in_backbone(flagship, train=True) == 25
