"""The fused training preprocess (``ops/fused_preprocess.py``,
``ops/csrc/train_preprocess.cu``): which input takes it, the table of draws
it reads, what it refuses, and the kernel's formulation written in torch
against the chain on the CPU. On the card the kernel against the chain:
``python -m pytest tests/test_torch_fused_preprocess.py -m card
--noconftest`` (no JAX is imported here)."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from vision_collision_detection_tpu_torch.config import AugmentConfig
from vision_collision_detection_tpu_torch.ops import affine
from vision_collision_detection_tpu_torch.ops import color as C
from vision_collision_detection_tpu_torch.ops import fused_preprocess as fp
from vision_collision_detection_tpu_torch.ops.augment import sample_clip_params
from vision_collision_detection_tpu_torch.ops.preprocess import (
    train_preprocess,
    train_preprocess_plain,
)

# vivit_small's augmentation (no blur), every clip augmented
BASE = AugmentConfig(blur_sigma=0.0, aug_probability=1.0)
# each step forced on, one at a time
CASES = {
    "draws": {},
    "flip": {"horizontal_flip_prob": 1.0},
    "skip": {"aug_probability": 0.0},
    "grayscale": {"grayscale_prob": 1.0},
    "cutout": {"cutout_prob": 1.0},
    "posterize": {"posterization_prob": 1.0},
    "solarize": {"solarization_prob": 1.0},
    "invert": {"color_inversion_prob": 1.0},
    "disabled": {"enabled": False},
}


def _cfg(case, mode="separable", **more):
    return dataclasses.replace(BASE, affine_mode=mode, **CASES[case], **more)


def _frames(shape, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g,
                         dtype=torch.uint8).to(device)


# ---- the route ----------------------------------------------------------

@pytest.mark.parametrize("shape,dtype,device,more,want", [
    ((8, 32, 189, 336, 3), torch.uint8, "cuda", {}, "fused"),
    ((8, 50, 126, 224, 3), torch.uint8, "cuda", {}, "fused"),
    ((2, 3, 336, 200, 3), torch.uint8, "cuda", {}, "fused"),
    ((2, 3, 336, 336, 3), torch.uint8, "cuda", {}, "fused"),
    ((8, 32, 189, 336, 3), torch.uint8, "cpu", {}, "plain"),
    ((8, 32, 189, 336, 3), torch.float32, "cuda", {}, "plain"),
    ((8, 32, 180, 320, 3), torch.uint8, "cuda", {}, "plain"),
    ((8, 32, 400, 336, 3), torch.uint8, "cuda", {}, "plain"),
    ((8, 32, 189, 336, 4), torch.uint8, "cuda", {}, "plain"),
    ((32, 189, 336, 3), torch.uint8, "cuda", {}, "plain"),
    ((8, 32, 189, 336, 3), torch.uint8, "cuda", {"blur_sigma": 0.5}, "plain"),
    ((8, 32, 189, 336, 3), torch.uint8, "cuda", {"noise_level": 0.02},
     "plain"),
])
def test_route_takes_pixelwise_content_on_the_card(shape, dtype, device, more,
                                                   want):
    cfg = dataclasses.replace(BASE, **more)
    assert fp.route(shape, dtype, device, cfg, 336 if 336 in shape else 224
                    ) == want


def test_route_follows_the_flagship_default_blur():
    """The flagship's default configuration blurs: its step keeps the
    chain; vivit_small's (no blur) takes the kernel."""
    shape = (8, 50, 126, 224, 3)
    assert fp.route(shape, torch.uint8, "cuda", AugmentConfig(), 224) == "plain"
    assert fp.route(shape, torch.uint8, "cuda",
                    AugmentConfig(blur_sigma=0.0), 224) == "fused"


# ---- the table --------------------------------------------------------------

@pytest.mark.parametrize("mode", fp.WARP_MODES)
def test_param_table_holds_the_chains_draws(mode):
    """The table's columns are the chain's parameters from the same draws:
    the flips and the gates, the warp's coefficients (``_inverse_coeffs``'s
    factoring, or the gather map's), the active cutout boxes."""
    cfg = _cfg("draws", mode, cutout_prob=0.5, grayscale_prob=0.5,
               posterization_prob=0.5, solarization_prob=0.5,
               color_inversion_prob=0.5)
    B, S = 16, 64
    table = fp.draw_table(torch.Generator().manual_seed(3), B, cfg, S)
    g = torch.Generator().manual_seed(3)
    flip = torch.rand((B, 1, 1, 1, 1), generator=g) < cfg.horizontal_flip_prob
    p = sample_clip_params(g, cfg, S, S, batch=B)
    assert table.shape == (B, fp.columns(cfg)) == (B, fp.BOXES + 8)
    assert table.dtype == torch.float32
    col = lambda k: table[:, k]  # noqa: E731
    assert torch.equal(col(fp.FLIP), flip.reshape(B).float())
    for k, name in ((fp.SKIP, "skip"), (fp.GRAYSCALE, "grayscale"),
                    (fp.POSTERIZE, "posterize"), (fp.SOLARIZE, "solarize"),
                    (fp.INVERT, "invert"), (fp.BRIGHTNESS, "brightness"),
                    (fp.CONTRAST, "contrast"), (fp.SATURATION, "saturation"),
                    (fp.HUE, "hue"), (fp.POSTERIZE_BITS, "posterize_bits")):
        assert torch.equal(col(k), p[name].float()), name
    assert torch.equal(col(fp.CUTS),
                       (p["cutout"] * p["cutout_count"]).float())
    boxes = table[:, fp.BOXES:].reshape(B, 2, 4)
    for k, name in enumerate(("cutout_top", "cutout_left", "cutout_h",
                              "cutout_w")):
        assert torch.equal(boxes[..., k], p[name].float()), name
    warp = table[:, fp.WARP:fp.BOXES]
    if mode == "separable":
        (m00, m01, ox), (m10, m11, oy) = affine._inverse_coeffs(
            S, S, p["rotation"], p["translate"], p["scale"], p["shear"])
        eps = m01 / m11
        want = [m00 - eps * m10, eps, ox - eps * oy, m10, m11, oy]
    else:
        want = list(affine._coeffs(p["rotation"], p["shear"])) + [
            p["scale"], p["translate"][:, 0], p["translate"][:, 1]]
    for k, w in enumerate(want):
        assert torch.equal(warp[:, k], w), k
    assert not warp[:, len(want):].any()
    # the draws are the chain's, so a generator left after the table stands
    # where the chain's stands
    g2 = torch.Generator().manual_seed(3)
    fp.draw_table(g2, B, cfg, S)
    assert torch.equal(torch.rand(4, generator=g2), torch.rand(4, generator=g))


def test_param_table_without_augmentation_skips_every_clip():
    cfg = _cfg("disabled", horizontal_flip_prob=1.0)
    table = fp.draw_table(torch.Generator().manual_seed(0), 3, cfg, 32)
    assert torch.equal(table[:, fp.SKIP], torch.ones(3))
    assert torch.equal(table[:, fp.FLIP], torch.ones(3))
    assert not table[:, fp.BRIGHTNESS:].any()


# ---- what the wrapper refuses -------------------------------------------

@pytest.mark.parametrize("what", ["cpu", "float", "not_content", "blur",
                                  "noise", "out_dtype"])
def test_fused_wrapper_refuses_what_it_does_not_take(what):
    frames = _frames((2, 3, 18, 32, 3))
    cfg, S, out_dtype = _cfg("draws"), 32, torch.bfloat16
    if what == "float":
        frames = frames.float()
    elif what == "not_content":
        S = 40
    elif what == "blur":
        cfg = dataclasses.replace(cfg, blur_sigma=0.5)
    elif what == "noise":
        cfg = dataclasses.replace(cfg, noise_level=0.02)
    elif what == "out_dtype":
        out_dtype = torch.float16
    g = torch.Generator().manual_seed(0)
    before = g.get_state()
    with pytest.raises(ValueError):
        fp.fused_train_preprocess(g, frames, cfg, S, out_dtype)
    assert torch.equal(g.get_state(), before), "drew before refusing"


def test_cpu_calls_take_the_chain_uncounted():
    frames = _frames((2, 3, 18, 32, 3))
    before = (fp.fused_train_preprocess.launches,
              train_preprocess.plain_cuda_calls)
    out = train_preprocess(torch.Generator().manual_seed(0), frames,
                           _cfg("draws"), 32, torch.float32)
    assert out.shape == (2, 3, 32, 32, 3)
    assert (fp.fused_train_preprocess.launches,
            train_preprocess.plain_cuda_calls) == before


class _Lib:
    """A stand-in for the kernel library: records the C entry's arguments
    and returns success."""

    def __init__(self):
        self.calls = []

    def vcd_train_preprocess(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("augment,kernels", [(1, 2), (0, 1)])
@pytest.mark.parametrize("mode", fp.WARP_MODES)
def test_launch_passes_the_geometry_and_counts_each_kernel(monkeypatch, mode,
                                                           augment, kernels):
    """``_launch`` is the one caller of ``vcd_train_preprocess``: it hands
    over the shapes, the table's width, the warp, the normalisation and the
    output's dtype code, and counts the kernels the entry launches (the
    contrast means only with ``augment``)."""
    lib = _Lib()
    monkeypatch.setattr(fp._build, "lib", lambda: lib)
    monkeypatch.setattr(fp._build, "stream_ptr", lambda device: 1234)
    cfg = _cfg("draws", mode)
    frames = _frames((2, 3, 18, 32, 3))
    table = fp.draw_table(torch.Generator().manual_seed(0), 2, cfg, 32)
    means = torch.empty(6)
    out = torch.empty(2, 3, 32, 32, 3, dtype=torch.float32)
    before = fp.fused_train_preprocess.launches
    fp._launch(frames, table, means, out, cfg, augment)
    assert fp.fused_train_preprocess.launches == before + kernels
    (args,) = lib.calls
    assert args[:4] == (frames.data_ptr(), table.data_ptr(),
                        means.data_ptr(), out.data_ptr())
    assert args[4:12] == (2, 3, 18, 32, 32, fp.columns(cfg),
                          int(mode != "separable"), augment)
    assert args[12:18] == (*cfg.normalize_mean, *cfg.normalize_std)
    assert args[18:] == (cfg.solarization_threshold, 1, 1234)


# ---- the kernel's formulation against the chain --------------------------

def _band(c, i):
    return (1.0 - (c - i).abs()).clamp_min(0.0).to(torch.bfloat16).float()


def _four_taps(a, w, S):
    """The separable warp as the kernel takes it: for output (j, x) the rows
    i0 = ⌊q⌋ and i0 + 1, q = m10·x + m11·j + oy, and in each row i the
    columns ⌊p⌋ and ⌊p⌋ + 1, p = δ·x + ε·i + ζ; bf16 operands and band
    weights, each row's two products summed in float32 and rounded to bf16,
    then the rows'."""
    B, T = a.shape[:2]
    d, e, z, m10, m11, oy = w[:6]
    xs = torch.arange(S, dtype=torch.float32)
    a16 = a.to(torch.bfloat16).float()
    bi = torch.arange(B)[:, None, None, None]
    ti = torch.arange(T)[None, :, None, None]
    q = m10 * xs[None, None, :] + m11 * xs[None, :, None] + oy
    i0 = torch.floor(q)
    out = torch.zeros_like(a)
    for r in (0, 1):
        i = i0 + r
        row_in = (i >= 0) & (i < S)
        p = d * xs[None, None, :] + e * i + z
        k0 = torch.floor(p)
        t = torch.zeros_like(a)
        for c in (0, 1):
            k = k0 + c
            ok = row_in & (k >= 0) & (k < S)
            v = a16[bi, ti, i.clamp(0, S - 1).long()[:, None],
                    k.clamp(0, S - 1).long()[:, None]]
            v = torch.where(ok[:, None, ..., None], v, 0.0)
            t = t + _band(p, k)[:, None, ..., None] * v
        wy = torch.where(row_in, _band(q, i), 0.0)
        out = out + wy[:, None, ..., None] * t.to(torch.bfloat16).float()
    return out


def kernel_formulation(frames_u8, table, cfg, S, out_dtype):
    """What the kernel computes, from the frames and the table alone,
    written in torch: the flip as a read of column S − 1 − k of the
    letterboxed frame, the colour steps on every pixel, the warp by its
    taps, then the gates, boxes and skip of the table."""
    B, T, ch, cw, _ = frames_u8.shape
    ph, pw = (S - ch) // 2, (S - cw) // 2
    per = lambda k: table[:, k].reshape(B, 1, 1, 1, 1)  # noqa: E731
    x = torch.zeros(B, T, S, S, 3)
    x[:, :, ph:ph + ch, pw:pw + cw] = frames_u8.float() / 255.0
    x = torch.where(per(fp.FLIP) != 0, x.flip(-2), x)
    a = C.adjust_brightness(x, per(fp.BRIGHTNESS))
    a = C.adjust_contrast(a, per(fp.CONTRAST))
    a = C.adjust_saturation(a, per(fp.SATURATION))
    a = C.adjust_hue(a, table[:, fp.HUE].reshape(B, 1, 1, 1))
    w = [table[:, fp.WARP + k].reshape(B, 1, 1) for k in range(7)]
    if cfg.affine_mode == "separable":
        y = _four_taps(a, w, S)
    else:
        ia, ib, ic, id_, scale, tx, ty = w
        xs = torch.arange(S, dtype=torch.float32)
        c = (S - 1) * 0.5
        dx = xs[None, None, :] - c - tx
        dy = xs[None, :, None] - c - ty
        y = affine.bilinear_sample(a, (ic * dx + id_ * dy) / scale + c,
                                   (ia * dx + ib * dy) / scale + c)
    y = torch.where(per(fp.GRAYSCALE) != 0, C.rgb_to_grayscale(y), y)
    bits = table[:, fp.POSTERIZE_BITS].to(torch.int32).reshape(B, 1, 1, 1, 1)
    y = torch.where(per(fp.POSTERIZE) != 0, C.posterize(y, bits), y)
    y = torch.where(per(fp.SOLARIZE) != 0,
                    C.solarize(y, cfg.solarization_threshold), y)
    y = torch.where(per(fp.INVERT) != 0, C.invert(y), y)
    ys = torch.arange(S)
    for k in range(int(cfg.cutout_count_range[1])):
        top, left, h, wd = (table[:, fp.BOXES + 4 * k + e].long()
                            .reshape(B, 1, 1) for e in range(4))
        on = (k < table[:, fp.CUTS]).reshape(B, 1, 1)
        inside = (on & (ys[:, None] >= top) & (ys[:, None] < top + h)
                  & (ys[None, :] >= left) & (ys[None, :] < left + wd))
        y = y * torch.where(inside, 0.0, 1.0)[:, None, ..., None]
    y = torch.where(per(fp.SKIP) != 0, x, y)
    mean = torch.tensor(cfg.normalize_mean)
    std = torch.tensor(cfg.normalize_std)
    return ((y - mean) / std).to(out_dtype)


@pytest.mark.parametrize("mode", fp.WARP_MODES)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("content,S", [((18, 32), 32), ((32, 22), 32)])
def test_kernel_formulation_matches_the_chain(content, S, case, mode):
    """On the CPU, from the same seed: the chain (``train_preprocess``) and
    the kernel's formulation from the table agree bit for bit. Rotation
    and shear widened so that the slanted taps show."""
    cfg = _cfg(case, mode, rotation_range=(-20.0, 20.0),
               shear_range=(-8.0, 8.0))
    frames = _frames((3, 2, *content, 3), seed=len(case))
    want = train_preprocess(torch.Generator().manual_seed(11), frames, cfg, S,
                            torch.float32)
    table = fp.draw_table(torch.Generator().manual_seed(11), 3, cfg, S)
    got = kernel_formulation(frames, table, cfg, S, torch.float32)
    assert got.shape == want.shape == (3, 2, S, S, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda")


# Kernel against chain on the card, |Δ| of the normalised frames. The two
# differ only in the contrast mean's sum order and in cuBLAS's luma dot
# products (a last bit of float32), which can flip a bf16-rounded operand
# of the separable warp (2^-8 of a value up to 1, / 0.225 normalised; two
# in one pixel allowed) and an output's last bf16 bit (2^-6 at |2.44|);
# posterize turns such a difference at a step's edge into a step (up to
# 32/255 / 0.225) at a few pixels. On an H100 the largest read 0.0173 (a
# float32 output, one operand flip), posterize 0.0697, and the mean at
# most 4e-8 (such flips are rare); a table with the hue off by 0.02 reads
# far above the mean's limit (chip_smoke.py, phase 28).
CARD_MAX = 2 ** -6 + 2 * 2 ** -8 / 0.225
CARD_POSTERIZE_MAX = CARD_MAX + 32 / 255 / 0.225
CARD_MEAN = 1e-5


@pytest.mark.card
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", fp.WARP_MODES)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("content,S", [((189, 336), 336), ((126, 224), 224)])
def test_fused_kernel_matches_the_chain_on_the_card(card, content, S, case,
                                                    mode, out_dtype):
    cfg = _cfg(case, mode)
    _kernel_against_chain(card, (4, 3, *content, 3), S, case, mode,
                          out_dtype)


@pytest.mark.card
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", fp.WARP_MODES)
@pytest.mark.parametrize("case", ["draws", "skip", "cutout"])
@pytest.mark.parametrize("shape,S", [((8, 32, 189, 336, 3), 336),
                                     ((8, 50, 126, 224, 3), 224)])
def test_fused_kernel_matches_the_chain_at_the_main_batches(card, shape, S,
                                                            case, mode,
                                                            out_dtype):
    """vivit_small's step batch and the flagship's: clips of several groups
    of 8 frames, the flagship's last group partial (50 = 6·8 + 2)."""
    _kernel_against_chain(card, shape, S, case, mode, out_dtype)


def _kernel_against_chain(card, shape, S, case, mode, out_dtype):
    cfg = _cfg(case, mode)
    frames = _frames(shape, seed=7, device=card)
    before = fp.fused_train_preprocess.launches
    got = train_preprocess(torch.Generator(card).manual_seed(5), frames, cfg,
                           S, out_dtype)
    assert fp.fused_train_preprocess.launches == before + (
        2 if cfg.enabled else 1)
    want = train_preprocess_plain(torch.Generator(card).manual_seed(5),
                                  frames, cfg, S, out_dtype)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs()
    mx = CARD_POSTERIZE_MAX if case == "posterize" else CARD_MAX
    assert float(err.max()) <= mx, (float(err.max()), float(err.mean()))
    assert float(err.mean()) <= CARD_MEAN, float(err.mean())
