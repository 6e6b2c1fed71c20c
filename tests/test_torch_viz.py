"""The port's attention view, clip previews, result cards and the two plots
of ``obs/plots.py`` it lacked, against the JAX package's
``vision_collision_detection_tpu/obs/viz.py`` and ``obs/plots.py`` on the
same seeded inputs; ``extract_attention_weights`` on weights carried across
by the bridge."""

import base64
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from torch_port_helpers import randomize_params, two_torch_threads  # noqa: F401
from vision_collision_detection_tpu.config import ExperimentConfig as JaxConfig
from vision_collision_detection_tpu.infer.predictor import (
    CollisionPredictor as JaxPredictor,
)
from vision_collision_detection_tpu.models import build_model as jax_build
from vision_collision_detection_tpu.obs import plots as jax_plots
from vision_collision_detection_tpu.obs import viz as jax_viz
from vision_collision_detection_tpu.ops.pallas_ops import (
    fused_dequant_normalize_pad,
)
from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.infer.predictor import (
    CollisionPredictor,
)
from vision_collision_detection_tpu_torch.models import build_model
from vision_collision_detection_tpu_torch.models.convert import load_flax_params
from vision_collision_detection_tpu_torch.obs import plots, viz
from vision_collision_detection_tpu_torch.ops.preprocess import eval_preprocess

AUG = ExperimentConfig().augment
MEAN, STD = AUG.normalize_mean, AUG.normalize_std


def test_denormalize_frames_bit_equal():
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 7, 3)).astype(np.float32)
    for mean, std in (((0.45,) * 3, (0.225,) * 3), (MEAN, STD)):
        got = viz.denormalize_frames(x, mean, std)
        want = jax_viz.denormalize_frames(x, mean, std)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


# ---- extract_attention_weights on bridged weights --------------------------

# (backbone, dtype, B, T, the port's blocks): resnet18 as the JAX package's
# own test; ConvNeXt-tiny at B·T = 4 with the port's stock blocks in float32
# and on its kernel path (K2 and K3's plain versions here) in bf16, against
# the JAX model's stock blocks. Every case enters through K1 (the port's
# plain version; the JAX Pallas kernel in interpret mode).
CASES = {
    "resnet18_f32": ("resnet18", "float32", 2, 5, "stock"),
    "convnext_f32": ("convnext_tiny", "float32", 2, 2, "stock"),
    "convnext_bf16": ("convnext_tiny", "bfloat16", 2, 2, "kernels"),
}
S = 32
CONTENT = (18, 32)  # a 16:9 source letterboxed into 32²


def _overrides(backbone, dtype):
    return {"model.backbone": backbone, "model.temporal_mode": "attention",
            "model.dtype": dtype, "data.frame_size": S,
            "model.temporal_hidden_dim": 24}


def _bridged(backbone, dtype, x, seed, blocks="kernels"):
    """(flax model, variables, port model) of one configuration on the same
    seeded weights; ``blocks`` "stock" builds the port's ConvNeXt without
    K2 and K3."""
    over = _overrides(backbone, dtype)
    fm = jax_build(JaxConfig().override(over).model)
    shapes = jax.eval_shape(fm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)
    v = {"params": randomize_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]), rng)}
    if "batch_stats" in shapes:
        # running means about 0, so the ReLUs leave features that differ
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, s: (rng.uniform(0.5, 1.5, s.shape)
                             if path[-1].key == "var" else
                             rng.normal(0, 0.1, s.shape)).astype(np.float32),
            shapes["batch_stats"])
    switch = False if blocks == "stock" else None
    tm = build_model(ExperimentConfig().override(over).model, device="cpu",
                     dwconv_kernel=switch, fused_mlp=switch)
    load_flax_params(tm, v)
    return fm, v, tm


@pytest.fixture(scope="module")
def readings():
    """Each case's (port, JAX) logits, per-frame importance and full
    matrix, computed once."""
    cache = {}

    def get(case):
        if case in cache:
            return cache[case]
        backbone, dtype, B, T, blocks = CASES[case]
        rng = np.random.default_rng(3)
        u8 = rng.integers(0, 256, (B, T, *CONTENT, 3), dtype=np.uint8)
        jx = fused_dequant_normalize_pad(
            jnp.asarray(u8.reshape(B * T, *CONTENT, 3)), S, MEAN, STD,
            out_dtype=getattr(jnp, dtype), interpret=True).reshape(
                B, T, S, S, 3)
        fm, v, tm = _bridged(backbone, dtype, np.zeros(jx.shape, np.float32),
                             11, blocks)
        jl, jfull = jax_viz.extract_attention_weights(fm, v, jx,
                                                      per_frame=False)
        _, jper = jax_viz.extract_attention_weights(fm, v, jx)
        x = eval_preprocess(torch.from_numpy(u8), AUG, S,
                            getattr(torch, dtype), use_kernel="force")
        tl, tfull = viz.extract_attention_weights(tm, x, per_frame=False)
        _, tper = viz.extract_attention_weights(tm, x)
        cache[case] = {
            "port": (tl.float().numpy(), tper, tfull),
            "jax": (np.asarray(jl, np.float32), np.asarray(jper),
                    np.asarray(jfull)),
            "shape": (B, T)}
        return cache[case]

    return get


# Tolerances (full matrix, per-frame importance), absolute. float32: 1e-5,
# the products summed in other orders. On the kernel path in float32 the
# two sides differ at the bf16 level, since K3's rule rounds t and h to bf16
# (tests/test_torch_kernels.py holds K3 to 2 bf16 ulps). bf16: the
# activations rounded at other places through 18 blocks; read 5.65e-3 on
# the full matrix and 1.09e-3 per frame (CPU, seeds as below).
ATTN_TOL = {"resnet18_f32": (1e-5, 1e-5), "convnext_f32": (1e-5, 1e-5),
            "convnext_bf16": (2e-2, 5e-3)}


@pytest.mark.parametrize("case", list(CASES))
def test_attention_weights_match_jax(readings, case):
    r = readings(case)
    B, T = r["shape"]
    (tl, tper, tfull), (jl, jper, jfull) = r["port"], r["jax"]
    assert tper.dtype == tfull.dtype == np.float32
    assert tfull.shape == jfull.shape == (B, 4, T, T)
    assert tper.shape == jper.shape == (B, T)
    np.testing.assert_allclose(tfull.sum(-1), 1.0, atol=1e-5)
    # the per-frame form is the full matrix's mean over heads and queries
    np.testing.assert_array_equal(tper, tfull.mean(axis=(1, 2)))
    full_tol, frame_tol = ATTN_TOL[case]
    np.testing.assert_allclose(tfull, jfull, rtol=0, atol=full_tol)
    np.testing.assert_allclose(tper, jper, rtol=0, atol=frame_tol)
    # the importance spreads across frames far past the tolerance
    assert float((jper.max(1) - jper.min(1)).min()) > 10 * frame_tol
    assert tl.shape == jl.shape == (B, 3)
    assert np.all(np.isfinite(tl))


@pytest.fixture(scope="module")
def resnet_attention():
    # each frame at its own level, so that the frames' features differ
    x = np.random.default_rng(4).normal(size=(2, 5, S, S, 3)) + np.linspace(
        -2, 2, 5)[None, :, None, None, None]
    x = x.astype(np.float32)
    _, _, tm = _bridged("resnet18", "float32", x, 12, "stock")
    return tm, torch.from_numpy(x)


def test_extract_restores_mode_and_matches_forward(resnet_attention):
    tm, x = resnet_attention
    tm.train()
    logits, _ = viz.extract_attention_weights(tm, x)
    assert tm.training
    tm.eval()
    with torch.no_grad():
        assert torch.equal(logits, tm(x))


def test_second_call_returns_its_own_matrix(resnet_attention):
    """A second call on another batch returns that batch's matrix; and
    where its forward does not reach the head, it raises rather than
    return the matrix the first call left."""
    tm, x = resnet_attention
    _, first = viz.extract_attention_weights(tm, x, per_frame=False)
    _, second = viz.extract_attention_weights(tm, x.flip(1), per_frame=False)
    assert np.abs(first - second).max() > 1e-2
    np.testing.assert_array_equal(second, viz.extract_attention_weights(
        tm, x.flip(1), per_frame=False)[1])

    class HeadNotCalled(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, frames):
            return frames.mean(dim=(1, 2, 3))

    assert tm.temporal.last_attention_weights is not None
    with pytest.raises(ValueError, match="attention head"):
        viz.extract_attention_weights(HeadNotCalled(tm), x)
    assert tm.temporal.last_attention_weights is None


def test_pooling_head_raises():
    """A model without an attention head raises the JAX function's
    ``ValueError``."""
    over = {"model.backbone": "resnet18", "model.temporal_mode": "pooling",
            "model.dtype": "float32", "data.frame_size": S}
    tm = build_model(ExperimentConfig().override(over).model, device="cpu")
    with pytest.raises(ValueError, match="no attention head "
                       r"\(temporal_mode='attention' required\)"):
        viz.extract_attention_weights(tm, torch.zeros(1, 4, S, S, 3))


# ---- overlay, previews ------------------------------------------------------

def _capture(monkeypatch, module):
    calls = []
    monkeypatch.setattr(module, "encode_video",
                        lambda path, frames, fps=10.0: calls.append(
                            (os.path.basename(path), np.array(frames), fps)))
    return calls


@pytest.mark.parametrize("shape,bar", [((7, 33, 45, 3), 8), ((5, 32, 48, 3), 3)])
def test_overlay_frames_bit_equal(monkeypatch, tmp_path, shape, bar):
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, shape, dtype=np.uint8)
    weights = rng.random(shape[0]).astype(np.float32)
    got, want = _capture(monkeypatch, viz), _capture(monkeypatch, jax_viz)
    for mod, calls in ((viz, got), (jax_viz, want)):
        out = mod.render_attention_overlay(frames, weights,
                                           str(tmp_path / "o.mp4"), fps=5,
                                           bar_height=bar)
        assert out == str(tmp_path / "o.mp4") and len(calls) == 1
    (_, g, gfps), (_, w, wfps) = got[0], want[0]
    assert g.shape == (shape[0], shape[1] - shape[1] % 2,
                       shape[2] - shape[2] % 2, 3)
    np.testing.assert_array_equal(g, w)
    assert gfps == wfps == 5
    # the private helper is the overlay before the crop
    np.testing.assert_array_equal(
        viz._overlay_frames(frames, weights, bar)[:, :g.shape[1], :g.shape[2]],
        g)


def _strip_videos(html):
    return re.sub(r"base64,[A-Za-z0-9+/=]*", "base64,", html)


def _previews(out_dir):
    return sorted(f for f in os.listdir(out_dir) if f.endswith(".mp4"))


def _same_preview(got_html, want_html, n):
    got, want = open(got_html).read(), open(want_html).read()
    assert _strip_videos(got) == _strip_videos(want)
    assert got.count("data:video/mp4;base64") == n
    assert _previews(os.path.dirname(got_html)) == _previews(
        os.path.dirname(want_html))
    assert len(_previews(os.path.dirname(got_html))) == n
    # each embedded video decodes as the MP4 written beside it
    first = re.search(r"base64,([A-Za-z0-9+/=]*)", got).group(1)
    path = os.path.join(os.path.dirname(got_html),
                        _previews(os.path.dirname(got_html))[0])
    assert base64.b64decode(first) == open(path, "rb").read()


@pytest.mark.parametrize("kind", ["uint8", "normalized"])
def test_export_batch_preview_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (3, 6, 33, 40, 3), dtype=np.uint8)
    if kind == "normalized":
        frames = (frames / 255.0 - 0.45) / 0.225
    batch = {"frames": frames, "id": ["a", "b<c", "d"],
             "target": np.array([0, 1, 2])}
    got = viz.export_batch_preview(batch, str(tmp_path / "port"), fps=5,
                                   max_clips=2)
    want = jax_viz.export_batch_preview(batch, str(tmp_path / "jax"), fps=5,
                                        max_clips=2)
    _same_preview(got, want, 2)


def test_show_batch_matches_jax(tmp_path):
    from vision_collision_detection_tpu.data.datasets import (
        create_datasets_with_manual_split as jax_split,
    )
    from vision_collision_detection_tpu_torch.data.datasets import (
        create_datasets_with_manual_split,
    )
    from vision_collision_detection_tpu_torch.media.synthetic import (
        generate_dataset,
    )

    csv = generate_dataset(str(tmp_path / "synth"), clips_per_class=1,
                           num_frames=12, fps=4, height=40, width=56,
                           splits=("train",), with_sensors=False)
    df = pd.read_csv(csv).fillna({"sensor_path": ""})
    common = dict(fps=2, duration=2, frame_size=32, train_strategy="center")
    train, _, _ = create_datasets_with_manual_split(df, **common)
    jtrain, _, _ = jax_split(df, **common)
    got = train.show_batch(str(tmp_path / "port"), max_clips=2)
    want = jtrain.show_batch(str(tmp_path / "jax"), max_clips=2)
    _same_preview(got, want, 2)
    got = train.show_batch(str(tmp_path / "port_idx"), indices=[2, 0], fps=3)
    want = jtrain.show_batch(str(tmp_path / "jax_idx"), indices=[2, 0], fps=3)
    _same_preview(got, want, 2)


# ---- result cards and the browser ------------------------------------------

RESULTS = [
    {"id": "clip_a", "video_path": "/x/clip_a.mp4", "success": True,
     "predicted_class": "Collision", "confidence": 0.8,
     "probabilities": {"Normal": 0.1, "Near Collision": 0.1,
                       "Collision": 0.8}},
    {"video_path": "/x/clip_b.mov", "success": True,
     "predicted_class": "Normal", "confidence": 0.5,
     "probabilities": {"Normal": 0.5, "Near Collision": 0.3,
                       "Collision": 0.2}},
    {"id": "clip_c", "success": False, "error": "decode failed"},
]


def _card(fig):
    ax = fig.axes[0]
    return ([t.get_text() for t in ax.texts],
            [(p.get_x(), p.get_width(), p.get_facecolor())
             for p in ax.patches])


@pytest.mark.parametrize("i", range(len(RESULTS)))
def test_result_card_matches_jax(i):
    import matplotlib.pyplot as plt

    got, want = viz.render_result_card(RESULTS[i]), jax_viz.render_result_card(
        RESULTS[i])
    assert _card(got) == _card(want)
    assert len(got.axes[0].patches) == (6 if RESULTS[i]["success"] else 0)
    plt.close("all")


@pytest.mark.parametrize("entry", ["browse_results", "display_results_widget"])
def test_browser_without_ipywidgets_matches_jax(monkeypatch, entry):
    """Without ipywidgets both packages render one card per result."""
    import matplotlib.pyplot as plt

    monkeypatch.setitem(sys.modules, "ipywidgets", None)
    if entry == "browse_results":
        got, want = viz.browse_results(RESULTS), jax_viz.browse_results(RESULTS)
    else:
        got = CollisionPredictor.display_results_widget(RESULTS)
        want = JaxPredictor.display_results_widget(RESULTS)
    assert isinstance(got, list) and len(got) == len(want) == 3
    assert [_card(f) for f in got] == [_card(f) for f in want]
    plt.close("all")


# ---- plots --------------------------------------------------------------------

def _png(path):
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_attention_heatmap_png(readings, tmp_path):
    full = readings("resnet18_f32")["port"][2]
    for mod, name in ((viz, "port.png"), (jax_viz, "jax.png")):
        out = mod.plot_attention_heatmap(full, str(tmp_path / "h" / name),
                                         clip_index=1)
        assert _png(out)


def test_acceleration_png_from_read_sensor_csv(tmp_path):
    from vision_collision_detection_tpu_torch.media.sensors import (
        read_sensor_csv,
    )

    t = np.arange(0, 5, 0.1)
    path = str(tmp_path / "s.csv")
    pd.DataFrame({"time_sec": t + 100, "accel_x_G": np.sin(t),
                  "accel_y_G": np.zeros_like(t),
                  "accel_z_G": np.ones_like(t)}).to_csv(path, index=False)
    df = read_sensor_csv(path)
    for mod, name in ((plots, "port.png"), (jax_plots, "jax.png")):
        assert _png(mod.plot_acceleration(df, str(tmp_path / name),
                                          event_time_sec=2.5))
    assert _png(plots.plot_acceleration(df, str(tmp_path / "none.png")))


@pytest.mark.parametrize("n", [1, 3])
def test_prediction_grid_png(tmp_path, n):
    rng = np.random.default_rng(7)
    frames = rng.random((n, 4, 16, 24, 3)).astype(np.float32)
    for mod, name in ((plots, "port.png"), (jax_plots, "jax.png")):
        assert _png(mod.plot_prediction_grid(frames, RESULTS[:n],
                                             str(tmp_path / name)))
