"""Serving bundles of the port (``infer/aot.py``) against the live forward
and against the JAX package's bundles, on the CPU: convnext_tiny + GRU at
32², 12 frames folded to 6, content box 22×32, bridged weights; in float32
with the stock MLP (``fused_mlp=False``: K3's plain version rounds to bf16
whatever the model's dtype) and in bf16 with K2 and K3 on; a small ViViT
with ``attention_impl="flash"``. The exported graphs hold the kernels as
``vcd::`` ops (``ops/library.py``), whose CPU implementations are the
kernels' plain versions. Also the bundle's refusals, and a bundle served in
a process where the port's model code cannot be imported."""

import collections
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import randomize_params, two_torch_threads  # noqa: F401
from vision_collision_detection_tpu.config import ExperimentConfig as JaxConfig
from vision_collision_detection_tpu.infer import aot as jax_aot
from vision_collision_detection_tpu.infer.predictor import (
    CollisionPredictor as JaxPredictor,
)
from vision_collision_detection_tpu.models import build_model as jax_build
from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.infer import ServingBundle, aot
from vision_collision_detection_tpu_torch.infer.predictor import (
    CollisionPredictor,
)
from vision_collision_detection_tpu_torch.models.convert import (
    from_flax_params,
)

ROOT = Path(__file__).resolve().parents[1]
OVERRIDES = {"data.frame_size": 32, "data.fps": 6, "data.duration": 2}
BOX = (22, 32)
BUCKETS = (1, 2)
PROB_TOL = 1e-5  # float32 against the JAX package
BF16_TOL = 3e-2  # bf16 against the JAX package
LIVE_TOL = 1e-6  # a bundle against the forward it was exported from
VIVIT = {"model.backbone": "vivit_tiny", "model.patch_size": 14,
         "model.temporal_mode": "attention", "data.frame_size": 28,
         "data.fps": 1, "data.duration": 2, "model.attention_impl": "flash"}


def vcd_nodes(path):
    """The ``vcd::`` op nodes of an exported program, counted by op."""
    ep = torch.export.load(str(path))
    return collections.Counter(
        str(n.target) for gm in ep.graph_module.modules()
        if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes
        if n.op == "call_function" and str(n.target).startswith("vcd."))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = JaxConfig().override({**OVERRIDES, "model.dtype": "float32"})
    model = jax_build(cfg.model)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, 32, 32, 3), jnp.float32))
    params = randomize_params(
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                               shapes["params"]),
        np.random.default_rng(7))
    params["fc_out"]["kernel"] *= 10.0  # probabilities far from uniform
    root = tmp_path_factory.mktemp("aot")
    clips = np.random.default_rng(3).integers(0, 256, (3, 6, *BOX, 3),
                                              dtype=np.uint8)
    out = {"clips": clips, "root": root}
    for dt, fused in (("float32", False), ("bfloat16", True)):
        ov = {**OVERRIDES, "model.dtype": dt}
        pred = CollisionPredictor(ExperimentConfig().override(ov),
                                  from_flax_params(params), device="cpu",
                                  fused_mlp=fused)
        path = root / dt
        manifest = pred.export_serving(str(path), batch_sizes=BUCKETS,
                                       content_box=BOX)
        jax_path = root / f"jax_{dt}"
        # one bucket: the third clip is served zero-padded
        JaxPredictor(JaxConfig().override(ov), params).export_serving(
            str(jax_path), batch_sizes=(2,), content_box=BOX)
        out[dt] = {"pred": pred, "path": path, "manifest": manifest,
                   "bundle": ServingBundle(str(path), device="cpu"),
                   "jax": jax_aot.ServingBundle(str(jax_path))}
    yield out
    shutil.rmtree(root)  # about 110 MB a bundle


def _live(pred, clips, bucket):
    """The predictor's folded forward on ``clips`` in chunks of ``bucket``,
    each zero-padded to ``bucket`` as the bundle pads it."""
    forward = pred._make_forward(True)
    out = []
    for i in range(0, len(clips), bucket):
        chunk = clips[i:i + bucket]
        padded = np.zeros((bucket,) + chunk.shape[1:], np.uint8)
        padded[:len(chunk)] = chunk
        out.append(forward(padded).numpy()[:len(chunk)])
    return np.concatenate(out)


def test_forward_shape_folds_as_the_predictor():
    """For convnext the JAX function's answer; for a ViViT the port's
    predictor does not fold (``ROADMAP.md`` queue 3: the JAX predictor folds
    a ViViT too and hands it half its frames), and the bundle agrees."""
    for ov, box in (({}, None), ({}, (126, 224)), (OVERRIDES, BOX)):
        want = jax_aot._forward_shape(JaxConfig().override(ov), box)
        assert aot._forward_shape(ExperimentConfig().override(ov), box) == want
    vivit = {"model.backbone": "vivit_small", "model.patch_size": 14}
    assert jax_aot._forward_shape(JaxConfig().override(vivit), None) == (
        (25, 224, 224, 3), 2)
    assert aot._forward_shape(ExperimentConfig().override(vivit), None) == (
        (50, 224, 224, 3), 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bundle_matches_the_live_forward(setup, dtype):
    """Three clips: a chunk of 2 and one through bucket 1, then the same
    three through bucket 2 alone (the third zero-padded), each against
    the forward it was exported from on the same padded batches: one
    program (K1's plain version here in both), so bit for bit."""
    s = setup[dtype]
    bundle, clips = s["bundle"], setup["clips"]
    got = bundle.predict_probs(clips)
    want = np.concatenate([_live(s["pred"], clips[:2], 2),
                           _live(s["pred"], clips[2:], 1)])
    assert got.dtype == np.float32 and got.shape == (3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=LIVE_TOL)
    one_bucket = ServingBundle(str(s["path"]), device="cpu")
    one_bucket.buckets = [2]
    padded = one_bucket.predict_probs(clips)
    np.testing.assert_allclose(padded, _live(s["pred"], clips, 2), rtol=0,
                               atol=LIVE_TOL)
    assert np.array_equal(got, want)
    assert np.array_equal(padded, _live(s["pred"], clips, 2))
    results = bundle.predict(clips)
    assert [r["predicted_label"] for r in results] == list(got.argmax(1))
    assert list(results[0]["probabilities"]) == list(bundle.class_names)
    assert results[0]["confidence"] == float(got[0].max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bundle_matches_the_jax_bundle(setup, dtype):
    s = setup[dtype]
    got = s["bundle"].predict_probs(setup["clips"])
    want = s["jax"].predict_probs(setup["clips"])
    tol = PROB_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    ours, theirs = s["bundle"].manifest, s["jax"].manifest
    assert set(ours) - {"torch_version"} == set(theirs) - {"jax_version"}
    for key in ("format_version", "frame_shape", "folded_stride",
                "input_dtype", "class_names", "hyperparams"):
        assert ours[key] == theirs[key], key
    assert ours["platforms"] == ["cpu"] and ours["buckets"] == list(BUCKETS)


def test_graph_holds_the_kernels_as_ops(setup):
    """One program serves both buckets (one copy of the weights). It holds
    K1 once, K2 and K3 once a block (18 blocks) in bf16; in float32 with
    the stock MLP, K3 is no node."""
    for dt in ("bfloat16", "float32"):
        assert sorted(os.listdir(setup[dt]["path"])) == [aot.PROGRAM,
                                                         aot.MANIFEST]
    assert vcd_nodes(setup["bfloat16"]["path"] / aot.PROGRAM) == {
        "vcd.dequant_pad.default": 1, "vcd.dwconv7x7.default": 18,
        "vcd.convnext_mlp.default": 18}
    assert vcd_nodes(setup["float32"]["path"] / aot.PROGRAM) == {
        "vcd.dequant_pad.default": 1, "vcd.dwconv7x7.default": 18}


def test_vivit_bundle_holds_k4_per_spatial_block(tmp_path):
    torch.manual_seed(0)
    pred = CollisionPredictor(ExperimentConfig().override(VIVIT), None,
                              device="cpu")
    manifest = pred.export_serving(str(tmp_path / "vivit"),
                                   batch_sizes=(2,))
    assert manifest["folded_stride"] == 1
    assert manifest["frame_shape"] == [2, 28, 28, 3]
    assert vcd_nodes(tmp_path / "vivit" / aot.PROGRAM) == {
        "vcd.dequant_pad.default": 1,
        "vcd.flash_mha.default": pred.model.spatial_layers}
    clips = np.random.default_rng(4).integers(0, 256, (2, 2, 28, 28, 3),
                                              dtype=np.uint8)
    got = ServingBundle(str(tmp_path / "vivit"), device="cpu").predict_probs(
        clips)
    assert np.array_equal(got, pred._make_forward(False)(clips).numpy())


def test_bundle_refusals(setup, tmp_path):
    bundle = setup["float32"]["bundle"]
    with pytest.raises(ValueError, match="per-clip shape"):
        bundle.predict_probs(np.zeros((1, 6, 32, 32, 3), np.uint8))
    manifest = setup["float32"]["manifest"]
    for name, change, match in (
            ("newer", {"format_version": aot.FORMAT_VERSION + 1}, "newer"),
            ("card", {"platforms": ["cuda"]}, "exported for")):
        d = tmp_path / name
        d.mkdir()
        (d / aot.MANIFEST).write_text(json.dumps({**manifest, **change}))
        with pytest.raises(ValueError, match=match):
            ServingBundle(str(d), device="cpu")
    with pytest.raises(ValueError, match="device type"):
        aot.export_bundle(setup["float32"]["pred"], str(tmp_path / "x"),
                          platforms=["cuda"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingBundle(str(setup["float32"]["path"]))


def test_bundle_serves_without_model_code(setup, tmp_path):
    """A fresh process with the port's ``models`` package, pandas,
    matplotlib and JAX blocked loads the float32 bundle and serves the
    clips as this process does."""
    np.save(tmp_path / "clips.npy", setup["clips"])
    code = (
        "import sys\n"
        "for m in ('vision_collision_detection_tpu_torch.models', 'pandas', "
        "'matplotlib', 'jax', 'flax', 'vision_collision_detection_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "from vision_collision_detection_tpu_torch.infer import ServingBundle\n"
        f"b = ServingBundle({str(setup['float32']['path'])!r}, device='cpu')\n"
        f"np.save({str(tmp_path / 'probs.npy')!r}, "
        f"b.predict_probs(np.load({str(tmp_path / 'clips.npy')!r})))\n"
        "assert not any(k.startswith('vision_collision_detection_tpu_torch."
        "models') and v is not None for k, v in sys.modules.items())\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
    want = setup["float32"]["bundle"].predict_probs(setup["clips"])
    assert np.array_equal(np.load(tmp_path / "probs.npy"), want)


def test_eager_calls_through_the_ops(setup, monkeypatch):
    """The eager forward calls the ops its bundle holds, as many times as
    the graph holds them (K1 1, K2 18, K3 18), and with the ops swapped for
    their implementations (a straight call) gives the same probabilities."""
    from vision_collision_detection_tpu_torch.ops import library

    forward = setup["bfloat16"]["pred"]._make_forward(True)
    clips = setup["clips"][:2]
    want = forward(clips)
    impls = {"dequant_pad": library._k1._run,
             "dwconv7x7": library._k2._forward,
             "convnext_mlp": library._k3._eval}
    calls = collections.Counter()

    def straight(name):
        def run(*args):
            calls[name] += 1
            return impls[name](*args)
        return run

    for name in impls:
        monkeypatch.setattr(library, name, straight(name))
    assert torch.equal(forward(clips), want)
    assert calls == {"dequant_pad": 1, "dwconv7x7": 18, "convnext_mlp": 18}
