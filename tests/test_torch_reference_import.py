"""Reference checkpoints served by the port: ``from_torch_checkpoint`` on a
reference-format ``.pth`` (torch ``EnhancedFrameCNN`` state_dict plus its
``hyperparams`` contract) against the torch reference module itself and
against the JAX package's ``from_torch_checkpoint`` on the same file, for
convnext_tiny + GRU, resnet18 + attention and resnet18 with the conv,
pooling, lstm and rnn heads; the ``.npz`` pair the JAX package's
``cli.convert_weights --full`` writes; a DDP ``module.`` prefix; the
hyperparams contract; and the served forward from uint8 frames.

The torch reference modules are those of ``tests/test_import_reference.py``
and ``tests/test_convert.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_convert import TorchResNet18
from test_import_reference import (
    TorchConvNeXtTiny,
    TorchEnhancedFrameCNN,
    _randomize_running_stats,
)
from torch_port_helpers import two_torch_threads  # noqa: F401
from vision_collision_detection_tpu.infer import (
    CollisionPredictor as JaxPredictor,
)
from vision_collision_detection_tpu.models.import_torch import (
    import_checkpoint_file,
)
from vision_collision_detection_tpu_torch.infer.predictor import (
    CollisionPredictor,
)
from vision_collision_detection_tpu_torch.models.import_torch import (
    convert_reference_checkpoint,
    derive_hyperparams,
)

# (backbone, head, reference-model kwargs, seed)
CASES = {
    "convnext_tiny-gru": ("convnext_tiny", "gru", {}, 0),
    "resnet18-attention": ("resnet18", "attention", {}, 1),
    "resnet18-convolution": ("resnet18", "convolution", {}, 2),
    "resnet18-pooling": ("resnet18", "pooling", {}, 2),
    "resnet18-lstm": ("resnet18", "lstm", {"rnn_hidden_dim": 64}, 2),
    "resnet18-rnn": ("resnet18", "rnn", {"rnn_hidden_dim": 64}, 2),
}


def _reference(case):
    backbone, mode, kw, seed = CASES[case]
    torch.manual_seed(seed)
    net = TorchConvNeXtTiny() if backbone == "convnext_tiny" else \
        TorchResNet18()
    m = TorchEnhancedFrameCNN(net, 768 if backbone == "convnext_tiny"
                              else 512, mode, num_classes=3, **kw)
    _randomize_running_stats(m)
    with torch.no_grad():  # layer scales of order 1: no block an identity
        for name, p in m.named_parameters():
            if name.endswith("layer_scale"):
                p.uniform_(0.5, 1.5)
    return m.eval(), {"base_model": backbone, "temporal_mode": mode,
                      "num_classes": 3}


def _save(tmp_path, model, hp, name="best_model.pth"):
    path = str(tmp_path / name)
    torch.save({"model_state_dict": model.state_dict(), "hyperparams": hp},
               path)
    return path


def _frames(seed, T=12):
    return np.random.default_rng(seed).random((2, T, 64, 64, 3)).astype(
        np.float32)


def _port_logits(pred, x):
    with torch.no_grad():
        return pred.model(torch.from_numpy(x)).numpy()


def _jax_logits(pred, x):
    return np.asarray(jax.jit(lambda p, s, x: pred.model.apply(
        {"params": p, "batch_stats": s}, x))(
            pred.params, pred.batch_stats, jnp.asarray(x)))


@pytest.mark.parametrize("case", list(CASES))
def test_pth_serves_the_reference_logits(case, tmp_path):
    """The port's logits on default switches within 1e-4 absolute and 1e-4
    relative of the torch reference's and of the JAX package's default on
    the same ``.pth`` (as the JAX package's ``_roundtrip`` holds it). A
    float32 ConvNeXt runs K2 and the stock MLP by default, no K3."""
    model, hp = _reference(case)
    path = _save(tmp_path, model, hp)
    x = _frames(CASES[case][3])
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    pred = CollisionPredictor.from_torch_checkpoint(path, device="cpu")
    assert pred.device == torch.device("cpu") and not pred.model.training
    got = _port_logits(pred, x)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    jax_got = _jax_logits(JaxPredictor.from_torch_checkpoint(path), x)
    np.testing.assert_allclose(got, jax_got, atol=1e-4, rtol=1e-4)
    mode = CASES[case][1]
    assert pred.cfg.model.temporal_mode == (
        "conv" if mode == "convolution" else mode)
    assert pred.cfg.model.backbone == CASES[case][0]


def test_kernel_path_of_the_reference_convnext(tmp_path):
    """K3 asked for (``fused_mlp=True``; in float32 the default is the
    stock chain): K2 and K3 through their autograd Functions (on the CPU
    their plain versions, K3's rounding t and h to bf16 by its rule) within
    1e-3 of the reference's logits (measured 8.3e-5 on logits up to 0.065),
    visibly apart from the stock blocks, on the same weights. The default
    blocks take K2 and the stock MLP."""
    model, hp = _reference("convnext_tiny-gru")
    path = _save(tmp_path, model, hp)
    x = _frames(0)
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    pred = CollisionPredictor.from_torch_checkpoint(path, device="cpu",
                                                    fused_mlp=True)
    stock = CollisionPredictor.from_torch_checkpoint(path, device="cpu",
                                                     dwconv_kernel=False,
                                                     fused_mlp=False)
    default = CollisionPredictor.from_torch_checkpoint(path, device="cpu")
    blocks = [m for m in pred.model.modules()
              if hasattr(m, "use_fused_mlp")]
    assert len(blocks) == 18
    assert all(m.use_fused_mlp and m.use_dwconv_kernel for m in blocks)
    assert all(m.use_dwconv_kernel and not m.use_fused_mlp
               for m in default.model.modules()
               if hasattr(m, "use_fused_mlp"))
    got = _port_logits(pred, x)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    assert np.abs(got - _port_logits(stock, x)).max() > 1e-6
    sd, sd_stock = pred.model.state_dict(), stock.model.state_dict()
    w = sd["backbone.stage0_block0.dwconv.weight"]  # K2's [49, C] layout
    assert w.shape == (49, 96)
    assert torch.equal(w.t().reshape(96, 1, 7, 7),
                       sd_stock["backbone.stage0_block0.dwconv.weight"])


def test_default_switches_serve_the_reference(tmp_path):
    """A float32 reference checkpoint on default switches runs no K3 (K2's
    float32 plain version and the stock MLP): within 1e-4 of the reference
    module on logits of order 1 (``test_pth_serves_the_reference_logits``
    holds the same default against the JAX package's), where
    ``fused_mlp=True`` is visibly apart (K3's plain version rounds t and h
    to bf16)."""
    model, hp = _reference("convnext_tiny-gru")
    with torch.no_grad():  # logits of order 1, so K3's rounding shows
        model.classifier[8].weight.mul_(30.0)
    path = _save(tmp_path, model, hp)
    x = _frames(5)
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    got = _port_logits(CollisionPredictor.from_torch_checkpoint(
        path, device="cpu"), x)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    fused = _port_logits(CollisionPredictor.from_torch_checkpoint(
        path, device="cpu", fused_mlp=True), x)
    # ten times the tolerance (measured 1.9e-3 on logits up to 1.46; the
    # default 2.4e-7)
    assert np.abs(fused - ref).max() > 1e-3


def test_reference_convnext_pads_as_torchvision(tmp_path):
    """At 72² the reference ConvNeXt's stages are 18, 9, 4 and 2: the
    stride-2 downsamples drop the remainder of 9 rows, as torchvision's
    ``Conv2d(padding=0)`` does. The port's reference model pads so and
    serves the torch reference's logits within 1e-4, from the ``.pth`` and
    from the ``.npz`` that ``cli.convert_weights --full`` writes; flax's ``SAME`` (5 and
    3), which the flagship ConvNeXt and the JAX package's reference model
    keep, is visibly apart, and is what the JAX package serves."""
    model, hp = _reference("convnext_tiny-gru")
    path = _save(tmp_path, model, hp)
    x = np.random.default_rng(6).random((2, 12, 72, 72, 3)).astype(
        np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    pred = CollisionPredictor.from_torch_checkpoint(path, device="cpu")
    assert pred.model.backbone.padding == "VALID"
    got = _port_logits(pred, x)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    npz = str(tmp_path / "model.npz")
    import_checkpoint_file(path, npz)  # what cli.convert_weights --full does
    assert np.array_equal(_port_logits(CollisionPredictor.from_torch_checkpoint(
        npz, device="cpu"), x), got)
    pred.model.backbone.padding = "SAME"
    same = _port_logits(pred, x)
    # ten times the tolerance (measured 6.5e-3 on logits up to 0.067)
    assert np.abs(same - ref).max() > 1e-3
    # where the port departs: the JAX package's import pads SAME
    jax_got = _jax_logits(JaxPredictor.from_torch_checkpoint(path), x)
    np.testing.assert_allclose(jax_got, same, atol=1e-4, rtol=1e-4)


def test_npz_pair_and_ddp_prefix(tmp_path):
    """The ``.npz`` + ``.npz.hyperparams.json`` pair the JAX package's
    converter writes, and a checkpoint whose keys carry DDP's ``module.``,
    serve the same logits as the ``.pth``, bit for bit."""
    model, hp = _reference("resnet18-convolution")
    path = _save(tmp_path, model, hp)
    npz = str(tmp_path / "model.npz")
    import_checkpoint_file(path, npz)  # what cli.convert_weights --full does
    assert os.path.exists(npz + ".hyperparams.json")
    x = _frames(3)
    want = _port_logits(CollisionPredictor.from_torch_checkpoint(
        path, device="cpu"), x)
    got = _port_logits(CollisionPredictor.from_torch_checkpoint(
        npz, device="cpu"), x)
    assert np.array_equal(got, want)
    ddp = str(tmp_path / "ddp.pth")
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in
                                     model.state_dict().items()},
                "hyperparams": hp}, ddp)
    got = _port_logits(CollisionPredictor.from_torch_checkpoint(
        ddp, device="cpu"), x)
    assert np.array_equal(got, want)


def test_hyperparams_contract():
    """The head count the contract claims must divide the width; a missing
    one warns and takes 4; a unidirectional 3-layer GRU of 96 and 5
    classes are read from the shapes."""
    m, _ = _reference("resnet18-attention")
    sd = m.state_dict()
    with pytest.raises(ValueError, match="attention_heads"):
        derive_hyperparams(sd, {"base_model": "resnet18",
                                "attention_heads": 7})
    with pytest.warns(UserWarning, match="attention_heads"):
        assert derive_hyperparams(sd, {"base_model": "resnet18"})[
            "attention_heads"] == 4
    torch.manual_seed(3)
    m = TorchEnhancedFrameCNN(TorchResNet18(), 512, "gru", num_classes=5,
                              rnn_hidden_dim=96, rnn_num_layers=3,
                              rnn_bidirectional=False)
    hp = derive_hyperparams(m.state_dict(), {"base_model": "resnet18"})
    assert (hp["temporal_mode"], hp["rnn_hidden_dim"], hp["rnn_num_layers"],
            hp["rnn_bidirectional"], hp["num_classes"]) == (
                "gru", 96, 3, False, 5)
    _, variables = convert_reference_checkpoint(
        {"model_state_dict": m.state_dict(),
         "hyperparams": {"base_model": "resnet18"}})
    assert set(variables["params"]["temporal"]) == {
        "norm", "projection", "l0_fw_cell", "l1_fw_cell", "l2_fw_cell"}


def test_unidirectional_gru_with_five_classes(tmp_path):
    torch.manual_seed(3)
    m = TorchEnhancedFrameCNN(TorchResNet18(), 512, "gru", num_classes=5,
                              rnn_hidden_dim=96, rnn_num_layers=3,
                              rnn_bidirectional=False).eval()
    _randomize_running_stats(m)
    path = _save(tmp_path, m, {"base_model": "resnet18"})
    pred = CollisionPredictor.from_torch_checkpoint(path, device="cpu")
    assert pred.class_names == tuple(f"class_{i}" for i in range(5))
    x = _frames(4)
    with torch.no_grad():
        ref = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(_port_logits(pred, x), ref, atol=1e-4,
                               rtol=1e-4)


def test_served_forward_matches_jax(tmp_path):
    """uint8 letterbox content through ``_make_forward(folded_stride=True)``
    (K1's plain version, then the model with its own subsample off): the
    probabilities within 1e-5 of the JAX predictor's on the same file."""
    model, hp = _reference("resnet18-pooling")
    path = _save(tmp_path, model, hp)
    frames = np.random.default_rng(7).integers(0, 256, (2, 25, 126, 224, 3),
                                               dtype=np.uint8)
    pred = CollisionPredictor.from_torch_checkpoint(path, device="cpu")
    assert pred._fold_stride() == 2
    got = pred._make_forward(True)(frames).numpy()
    assert pred.model.frame_subsample == 2  # the copy's was turned off
    want = np.asarray(JaxPredictor.from_torch_checkpoint(path)._make_forward(
        True)(jnp.asarray(frames)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
