"""Serving from files, the port against the JAX package: ``predict`` on a
list and on a directory, ``evaluate`` and ``predict_sliding`` on synthetic
MP4s, convnext_tiny + GRU at 32² in float32 on bridged weights; and no
hidden fallback when the media library cannot be built.

The port's predictor runs its blocks with K2 (its plain version here) and
with the stock MLP in place of K3: K3's plain version rounds t and h_pre to
bf16 as the kernel does whatever the model's dtype, where the JAX package's
float32 model (K3 off by default there) does not. K3 is held against the
JAX package in tests/test_torch_predictor.py and tests/test_torch_kernels.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from torch_port_helpers import randomize_params
from vision_collision_detection_tpu.config import ExperimentConfig as JaxConfig
from vision_collision_detection_tpu.infer.predictor import (
    CollisionPredictor as JaxPredictor,
)
from vision_collision_detection_tpu.media.synthetic import generate_dataset
from vision_collision_detection_tpu.models import build_model as jax_build
from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.data.loader import ClipLoader, collate
from vision_collision_detection_tpu_torch.infer import predictor as predictor_mod
from vision_collision_detection_tpu_torch.infer.predictor import (
    CollisionPredictor,
)
from vision_collision_detection_tpu_torch.media import build, decoder
from vision_collision_detection_tpu_torch.models.convert import (
    from_flax_params,
)

# T = 6 fps × 2 s = 12 frames, folded to 6 by the stride of 2
OVERRIDES = {"data.frame_size": 32, "data.fps": 6, "data.duration": 2,
             "model.dtype": "float32"}
PROB_TOL = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = JaxConfig().override(OVERRIDES)
    model = jax_build(cfg.model)
    # every leaf is redrawn, so the tree's shapes are all that is needed
    shapes = jax.eval_shape(lambda k, x: model.init(k, x),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, 32, 32, 3), jnp.float32))
    params = randomize_params(
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                               shapes["params"]),
        np.random.default_rng(7))
    params["fc_out"]["kernel"] *= 10.0  # probabilities far from uniform
    d = tmp_path_factory.mktemp("serve")
    meta = pd.read_csv(generate_dataset(
        str(d), clips_per_class=2, num_frames=30, height=64, width=96))
    broken = str(d / "videos" / "broken.mp4")  # sorts first in the directory
    with open(broken, "w") as f:
        f.write("not a video")
    meta = pd.concat([meta.iloc[:2], pd.DataFrame([{
        "id": "broken", "video_path": broken, "video_type": "Collision"}]),
        meta.iloc[2:]], ignore_index=True)
    jpred = JaxPredictor(cfg, params)
    pred = CollisionPredictor(ExperimentConfig().override(OVERRIDES),
                              from_flax_params(params), device="cpu",
                              fused_mlp=False)
    return {"jax": jpred, "port": pred, "meta": meta,
            "dir": str(d / "videos")}


def _assert_results_match(got, want, key="id"):
    assert [r[key] for r in got] == [r[key] for r in want]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if k == "probabilities":
                assert list(g[k]) == list(w[k])
                np.testing.assert_allclose(list(g[k].values()),
                                           list(w[k].values()),
                                           rtol=0, atol=PROB_TOL)
            elif k == "confidence":
                assert abs(g[k] - w[k]) <= PROB_TOL
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("given", ["list", "directory"])
def test_predict_matches_jax(setup, given):
    """A list with the broken file third (the content box comes from the
    first clip: 22×32 content rows), and the directory, where the broken
    file comes first (no content box: square frames)."""
    videos = list(setup["meta"]["video_path"]) if given == "list" else setup["dir"]
    got = setup["port"].predict(videos, batch_size=4, num_workers=2)
    want = setup["jax"].predict(videos, batch_size=4, num_workers=2)
    assert len(got) == 7
    assert [r["success"] for r in got].count(False) == 1
    broken = next(r for r in got if not r["success"])
    assert broken["id"] == "broken" and broken["error"] == "decode failed"
    _assert_results_match(got, want)
    if given == "list":
        assert setup["port"]._content_box(videos[0]) == (22, 32)


def test_evaluate_matches_jax(setup, tmp_path):
    meta = setup["meta"]
    columns = {c: list(meta[c]) for c in ("video_path", "video_type")}
    png = str(tmp_path / "cm.png")
    got = setup["port"].evaluate(columns, batch_size=4,
                                 confusion_matrix_path=png)
    want = setup["jax"].evaluate(meta, batch_size=4)
    assert got["num_failed"] == want["num_failed"] == 1
    assert got["num_samples"] == 6
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, abs=1e-6, nan_ok=True), k
        else:
            assert got[k] == v, k
    assert os.path.getsize(png) > 0


def test_predict_sliding_matches_jax(setup):
    path = setup["meta"]["video_path"][0]  # 30 frames at 10 fps
    got = setup["port"].predict_sliding(path, stride_sec=0.2)
    want = setup["jax"].predict_sliding(path, stride_sec=0.2)
    # 20 native frames a window, a start every 2 frames: 6 windows of 12
    # frames drawn from 30 distinct ones, off the buckets of 64 and 8
    _, _, idx = predictor_mod.sliding_windows(30, 10.0, 2, 12, 0.2, 64)
    assert len(np.unique(idx)) % predictor_mod.POOL_BUCKET != 0
    assert len(idx) % predictor_mod.WINDOW_BUCKET != 0
    assert len(got) == len(want) == len(idx) == 6
    assert [r["start_sec"] for r in got] == pytest.approx(
        [0.0, 0.2, 0.4, 0.6, 0.8, 1.0])
    _assert_results_match(got, want, key="window")
    assert got[-1]["end_sec"] == pytest.approx(3.0)


def test_predict_batches_equal_the_forward_fed_directly(setup):
    """``predict``'s loop on a stand-in dataset (no decode): every clip's
    probabilities equal the forward on the same frames; a flagged clip is
    ``success: False``."""
    pred = setup["port"]
    rng = np.random.default_rng(4)
    clips = rng.integers(0, 256, (5, 6, 22, 32, 3), dtype=np.uint8)

    class StandIn:
        supports_batch = True

        def __len__(self):
            return len(clips)

        def get_batch(self, idxs, epoch=0, num_threads=0):
            return collate([{"frames": clips[i], "sensor": np.zeros((6, 4)),
                             "target": 0, "id": f"c{i}", "error": i == 3}
                            for i in idxs])

    results = pred._predict_batches(ClipLoader(StandIn(), 2), 2,
                                    {f"c{i}": f"/v/c{i}.mp4" for i in range(5)})
    want = pred._make_forward(True)(clips).numpy()
    assert [r["id"] for r in results] == [f"c{i}" for i in range(5)]
    for i, r in enumerate(results):
        assert r["video_path"] == f"/v/c{i}.mp4"
        assert r["success"] == (i != 3)
        if r["success"]:
            np.testing.assert_allclose(list(r["probabilities"].values()),
                                       want[i], rtol=0, atol=1e-6)


def test_missing_media_library_raises_out_of_predict(setup, tmp_path,
                                                     monkeypatch):
    """A media library that cannot be built raises ``MediaBuildError`` out
    of ``predict``; it does not turn every clip into a failed decode."""
    monkeypatch.setattr(build, "SOURCE", tmp_path / "missing" / "vcd_media.cpp")
    monkeypatch.setattr(decoder, "_lib", None)
    paths = list(setup["meta"]["video_path"])
    with pytest.raises(build.MediaBuildError):
        setup["port"].predict(paths, batch_size=4, num_workers=2)
    with pytest.raises(build.MediaBuildError):
        setup["port"].predict_sliding(paths[0])
    # the content-box probe is not where it is swallowed either
    monkeypatch.setattr(predictor_mod.CollisionPredictor, "_content_box",
                        lambda self, p: None)
    with pytest.raises(build.MediaBuildError):
        setup["port"].predict(paths, batch_size=4, num_workers=2)


def test_from_checkpoint_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from vision_collision_detection_tpu_torch.ckpt import CheckpointStore

    store = CheckpointStore(str(tmp_path / "run"))
    store.save("best", arrays={"model": {}}, meta={
        "hyperparams": ExperimentConfig().override(OVERRIDES).to_dict()})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CollisionPredictor.from_checkpoint(store.run_dir)
