"""The whole slice: the port's serving forward against the JAX package's
``CollisionPredictor._make_forward`` on bridged weights, convnext_tiny +
bi-GRU at 32² (B=2), and the entry points' CPU guard."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import randomize_params
from vision_collision_detection_tpu.config import ExperimentConfig as JaxConfig
from vision_collision_detection_tpu.infer.predictor import (
    CollisionPredictor as JaxPredictor,
)
from vision_collision_detection_tpu.models import build_model as jax_build
from vision_collision_detection_tpu.ops import convnext_mlp_pallas, dwconv_pallas
from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.infer.predictor import (
    CollisionPredictor,
)
from vision_collision_detection_tpu_torch.models import build_model
from vision_collision_detection_tpu_torch.models.convert import (
    from_flax_params,
)

S = 32
CONTENT = (18, 32)  # a 16:9 source letterboxed into 32²
OVERRIDES = {"data.frame_size": S}


@pytest.fixture(scope="module")
def flax_params():
    cfg = JaxConfig().override(OVERRIDES)
    model = jax_build(cfg.model)
    init = jax.jit(lambda k, x: model.init(k, x))(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, S, S, 3), jnp.float32))
    params = randomize_params(jax.device_get(init["params"]),
                              np.random.default_rng(7))
    # spread the logits so the probabilities are far from uniform
    params["fc_out"]["kernel"] *= 10.0
    return params


def _frames(T, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (2, T, *CONTENT, 3), dtype=np.uint8)


def _compare(flax_params, kernels_on, folded, monkeypatch):
    if kernels_on:
        # JAX through its Pallas kernels (interpret mode) at every stage
        monkeypatch.setattr(dwconv_pallas, "PALLAS_DWCONV_DEFAULT", True)
        monkeypatch.setattr(convnext_mlp_pallas, "FUSED_MLP_DEFAULT", True)
        monkeypatch.setattr(convnext_mlp_pallas, "FUSED_MLP_MIN_DIM", 0)
    jpred = JaxPredictor(JaxConfig().override(OVERRIDES), flax_params)
    switch = None if kernels_on else False
    tpred = CollisionPredictor(
        ExperimentConfig().override(OVERRIDES),
        from_flax_params(flax_params, dwconv_kernel=kernels_on),
        device="cpu", dwconv_kernel=switch, fused_mlp=switch)
    frames = _frames(6 if folded else 12, seed=int(folded))
    ref = np.asarray(jpred._make_forward(folded)(frames))
    got = tpred._make_forward(folded)(frames).numpy()
    assert got.shape == ref.shape == (2, 3)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    return got, ref


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("kernels_on", [False, True])
def test_slice_matches_jax_predictor(flax_params, kernels_on, folded,
                                     monkeypatch):
    got, ref = _compare(flax_params, kernels_on, folded, monkeypatch)
    # tolerance: bf16 activations through 18 blocks with γ of order 1, the
    # two frameworks rounding at other places. The probabilities span
    # 0.04..0.77 here and agree to 3e-2 absolute, with the same argmax.
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_fold_stride_and_display(capsys):
    pred = CollisionPredictor(ExperimentConfig().override(OVERRIDES), None,
                              device="cpu")
    assert pred._fold_stride() == 2
    assert pred._make_forward(True) is pred._make_forward(True)
    assert pred.model.frame_subsample == 2
    probs = pred._make_forward(True)(_frames(25, seed=3)).numpy()
    assert probs.shape == (2, 3)
    results = [{
        "id": str(i), "success": True,
        "predicted_class": pred.class_names[int(p.argmax())],
        "confidence": float(p.max()),
        "probabilities": dict(zip(pred.class_names, map(float, p))),
    } for i, p in enumerate(probs)]
    results.append({"id": "bad", "success": False, "error": "decode"})
    text = pred.display_results(results)
    assert "bad: ERROR (decode)" in text
    assert "Near Collision" in text and "%" in capsys.readouterr().out


def test_npz_written_by_jax_package_loads_in_port(flax_params, tmp_path):
    from vision_collision_detection_tpu.models.convert import save_npz

    from vision_collision_detection_tpu_torch.models.convert import load_npz

    path = str(tmp_path / "params.npz")
    save_npz(flax_params, path)
    got = from_flax_params(load_npz(path))
    want = from_flax_params(flax_params)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_state_dict_with_missing_key_raises(flax_params):
    sd = from_flax_params(flax_params)
    sd.pop("fc_out.bias")
    with pytest.raises(RuntimeError, match="Missing"):
        CollisionPredictor(ExperimentConfig().override(OVERRIDES), sd,
                           device="cpu")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ExperimentConfig().override(OVERRIDES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CollisionPredictor(cfg, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg.model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg.model, device="cuda")
    assert build_model(cfg.model, device="cpu").fc_out.weight.device.type == "cpu"
