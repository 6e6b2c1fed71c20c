"""TimeSformer (``models/timesformer.py``) against the published forward in
plain float32 PyTorch (``tests/timesformer_reference.py``; the JAX package
has no such model) on the CPU, at timesformer_tiny (dim 64, 4 heads of 16,
2 blocks) with 32² frames, patch 8 (16 patches a frame) and B ≤ 2: the
logits in float32 and bf16, one training step's gradients, the predictor's
probabilities, the benchmark's reference, the temporal path, and the
published preset's sizes on the meta device. On the card, K4 at the
published model's two attention shapes: ``python -m pytest
tests/test_torch_timesformer.py -m card --noconftest`` (nothing here
imports JAX)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import timesformer_reference as ref
from vision_collision_detection_tpu_torch.config import (
    ExperimentConfig,
    ModelConfig,
    whole_video,
)
from vision_collision_detection_tpu_torch.infer.predictor import (
    CollisionPredictor,
    fold_stride,
)
from vision_collision_detection_tpu_torch.models import build_model
from vision_collision_detection_tpu_torch.models.timesformer import (
    TimeSformer,
    build_timesformer,
)
from vision_collision_detection_tpu_torch.ops import flash_attention as fa
from vision_collision_detection_tpu_torch.ops.preprocess import (
    eval_preprocess,
)
from vision_collision_detection_tpu_torch.train import (
    create_train_state,
    make_train_step,
)

SIDE, PATCH, HEADS, T = 32, 8, 4, 4


def config(dtype="float32", **more) -> ExperimentConfig:
    return ExperimentConfig().override(dict({
        "model.backbone": "timesformer_tiny", "model.patch_size": PATCH,
        "model.attention_impl": "flash", "model.dtype": dtype,
        "data.frame_size": SIDE, "data.fps": T, "data.duration": 1}, **more))


def seeded(model: torch.nn.Module, seed: int = 3) -> dict:
    """Weights that make every part of the forward count: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), everything else N(0, 0.1²),
    the head × 5 so that the logits spread. → the float32 state dict."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=g)
            module, kind = name.rpartition(".")[::2]
            if p.dim() >= 2:
                p.copy_(z * (p[0].numel() ** -0.5)
                        * (5.0 if module == "head" else 1.0))
            elif "norm" in module.rpartition(".")[2] and kind == "weight":
                p.copy_(1.0 + 0.1 * z)
            else:
                p.copy_(0.1 * z)
    return {k: v.detach().float().clone() for k, v in
            model.state_dict().items()}


def frames(B=2, frames_=T, seed=1):
    return torch.randn(B, frames_, SIDE, SIDE, 3,
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_the_published_forward(dtype):
    model = build_model(config(dtype).model, device="cpu", frame_size=SIDE)
    assert isinstance(model, TimeSformer) and not model.training
    P = seeded(model)
    x = frames()
    with torch.no_grad():
        got = model(x)
        want = ref.logits(P, x, HEADS, PATCH)
    assert got.dtype == torch.float32 and got.shape == (2, 3)
    big = float(want.abs().max())
    assert big > 2.0  # the logits spread: the comparison has a scale
    # float32: the same sums in another order (the regroups, the fused
    # q, k, v, the patches by a product, not a convolution), 1e-5 of the
    # largest logit. bf16: the ViViT tests' rule, 1-ulp flips of the
    # activations through the blocks (2^-8 relative each) summed by the
    # head: 0.15 on logits of a few units
    tol = 1e-5 * big if dtype == "float32" else 0.15
    assert float((got - want).abs().max()) <= tol


def test_a_training_step_takes_the_published_gradients():
    """``make_train_step`` on model-ready frames in float32: every leaf's
    gradient against autograd of the published forward under the same
    weighted loss, within 1e-4 of that leaf's largest."""
    cfg = config()
    model, state = create_train_state(cfg, torch.Generator().manual_seed(0),
                                      steps_per_epoch=4, device="cpu")
    P = {k: v.requires_grad_(True) for k, v in seeded(model).items()}
    x = frames()
    targets, mask = torch.tensor([2, 0]), torch.ones(2)
    step = make_train_step(model, cfg, class_weights=[1.0, 2.0, 0.5],
                           preprocess=False)
    _, metrics = step(state, x, targets, mask, torch.Generator())
    w = torch.tensor([1.0, 2.0, 0.5])[targets]
    logp = torch.log_softmax(ref.logits(P, x, HEADS, PATCH), -1)
    loss = -(logp[torch.arange(2), targets] * w).sum() / w.sum()
    grads = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
    assert abs(float(metrics["loss"]) - float(loss.detach())) <= \
        1e-5 * float(loss.detach())
    # float32 sums in another order through two blocks and back: 1e-4 of
    # the leaf's largest, or of the median leaf's where the leaf's is
    # smaller (a key's bias, whose exact gradient is 0 under softmax)
    floor = float(np.median([float(g.abs().max()) for g in grads.values()]))
    for name, p in model.named_parameters():
        want = grads[name]
        assert float((p.grad - want).abs().max()) <= \
            1e-4 * max(float(want.abs().max()), floor), name


def test_the_predictor_serves_every_frame():
    """``CollisionPredictor`` on uint8 content of 12 frames (more than
    ``subsample_threshold``, where a frame model would fold by 2): stride 1,
    and the probabilities of the published forward on K1's frames."""
    cfg = config(**{"data.fps": 4, "data.duration": 3})
    assert whole_video("timesformer_hr") and fold_stride(cfg) == 1
    model = build_model(cfg.model, device="cpu", frame_size=SIDE)
    P = seeded(model)
    pred = CollisionPredictor(cfg, P, device="cpu")
    assert pred._fold_stride() == 1
    u8 = torch.randint(0, 256, (2, 12, 18, SIDE, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(4))
    got = pred._make_forward(False)(u8)
    x = eval_preprocess(u8, cfg.augment, SIDE, torch.float32,
                        use_kernel="force")
    with torch.no_grad():
        want = torch.softmax(ref.logits(P, x, HEADS, PATCH), -1)
    assert float((got - want).abs().max()) <= 1e-5


def test_the_benchmarks_reference_is_the_published_forward():
    from benchmark import harness
    from benchmark.architectures import timesformer
    from benchmark.reference.weights import make_params

    c = timesformer.shrink(harness.load_json(
        harness.HERE / "configs" / "timesformer_hr.json"))
    P = make_params(c, 2 ** 40 + 3, "cpu")
    x = frames()
    with torch.no_grad():
        got = timesformer.logits(P, x, c)
        want = ref.logits(P, x, c["heads"], c["patch_size"])
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_the_temporal_path_moves_the_logits():
    """With ``temporal_fc`` zeroed in every block the port and the reference
    still agree, and both move far past the float32 tolerance: the
    comparisons above cover the temporal attention."""
    model = build_model(config().model, device="cpu", frame_size=SIDE)
    P = seeded(model)
    x = frames()
    with torch.no_grad():
        full = model(x)
        for block in model.blocks:
            block.temporal_fc.weight.zero_()
            block.temporal_fc.bias.zero_()
        cut = model(x)
        Pz = {k: v.detach().float() for k, v in model.state_dict().items()}
        want = ref.logits(Pz, x, HEADS, PATCH)
    big = float(want.abs().max())
    assert float((cut - want).abs().max()) <= 1e-5 * big
    assert float((cut - full).abs().max()) > 100 * 1e-5 * big


def test_the_published_preset_on_meta():
    cfg = ExperimentConfig().override({
        "model.backbone": "timesformer_hr", "model.patch_size": 16,
        "model.attention_impl": "flash", "data.frame_size": 448,
        "data.fps": 4, "data.duration": 4})
    with torch.device("meta"):
        model = build_timesformer(cfg.model, cfg.data.frame_size)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sum(v.numel() for v in model.parameters()) == 121_718_787
    assert len(model.blocks) == 12
    assert shapes["pos_embed"] == (785, 768)
    assert shapes["time_embed"] == (16, 768)
    assert shapes["patch_embed.weight"] == (768, 3, 16, 16)
    assert shapes["blocks.11.temporal_fc.weight"] == (768, 768)
    assert shapes["blocks.0.attn.query.weight"] == (768, 768)
    assert shapes["blocks.0.mlp_fc1.weight"] == (3072, 768)
    assert shapes["head.weight"] == (3, 768)
    assert model.blocks[0].attn.head_dim == 64
    assert cfg.data.num_frames == 16 and fold_stride(cfg) == 1


def test_only_k4_attends():
    with pytest.raises(ValueError, match="attention_impl"):
        ExperimentConfig().override({"model.backbone": "timesformer_tiny"})
    with pytest.raises(ValueError, match="attention_impl"):
        build_model(ModelConfig(backbone="timesformer_tiny"), device="cpu")


# ---- the card ------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda")


def _held(got, want):
    """K4's bf16 rule (``chip_smoke.flash_tols``): 2^-6 of the largest value
    at most and 2^-8 of the mean |value| on the mean."""
    err = (got.float() - want.float()).abs()
    assert float(err.max()) <= 2 ** -6 * float(want.float().abs().max())
    assert float(err.mean()) <= 2 ** -8 * float(want.float().abs().mean())


# the published model at B=8: the spatial attention over the 785 tokens of
# each of 128 frames, and the temporal over the 16 frames at each of 6,272
# positions
DIVIDED_SHAPES = {"spatial": (128, 785, 12, 64), "temporal": (6272, 16, 12, 64)}


@pytest.mark.card
@pytest.mark.parametrize("name", list(DIVIDED_SHAPES))
def test_k4_at_the_divided_shapes(card, name):
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(DIVIDED_SHAPES[name], generator=g).to(
        card, torch.bfloat16) for _ in range(4))
    scale = 64 ** -0.5
    fa.flash_mha.wgmma_launches = 0
    o, lse = fa.flash_mha_fwd(q, k, v, scale)
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, scale)
    assert fa.flash_mha.wgmma_launches == 1
    _held(o, o_ref)
    assert float((lse - lse_ref).abs().max()) <= 1e-4
    di = fa.flash_mha_bwd_di(o, do)
    dk, dv = fa.flash_mha_bwd_dkv(q, k, v, do, lse, di, scale)
    dq = fa.flash_mha_bwd_dq(q, k, v, do, lse, di, scale)
    args = (q, k, v, do, lse, di, scale)
    _held(dq, fa.flash_mha_bwd_dq_plain(*args))
    dk_ref, dv_ref = fa.flash_mha_bwd_dkv_plain(*args)
    _held(dk, dk_ref)
    _held(dv, dv_ref)


@pytest.mark.card
def test_k4_reads_the_temporal_attention_through_strides(card):
    """The model's temporal call: the positions folded into the heads of the
    frame-major stream, [8, 16, 784·12, 64], equal to the same attention
    regrouped into [8·784, 16, 12, 64], forward and backward."""
    B, T_, N, H, D = 8, 16, 784, 12, 64
    g = torch.Generator().manual_seed(6)
    q, k, v, do = (torch.randn(B, T_, N * H, D, generator=g).to(
        card, torch.bfloat16) for _ in range(4))

    def regroup(t):
        return t.view(B, T_, N, H, D).transpose(1, 2).reshape(B * N, T_, H, D)

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_mha(*leaves, D ** -0.5)
    grads = torch.autograd.grad(o, leaves, do)
    flat = [regroup(t).clone().requires_grad_(True) for t in (q, k, v)]
    o2 = fa.flash_mha(*flat, D ** -0.5)
    grads2 = torch.autograd.grad(o2, flat, regroup(do))
    assert torch.equal(regroup(o), o2)
    for a, b in zip(grads, grads2):
        assert torch.equal(regroup(a), b)
