"""Train and eval steps.

Counterpart of ``vision_collision_detection_tpu/train/steps.py``. A train
step takes uint8 letterbox-content frames [B, T, ch, cw, 3], runs
``train_preprocess`` (flip, letterbox, augmentation, normalisation), the
model's forward in train mode, ``weighted_loss``, the backward (K2's, K3's
and K4's through their ``autograd.Function``s), gradient clipping and the
optimizer with its scheduled rate. Eager PyTorch around the hand-written
kernels; no ``torch.compile``.

The loss follows the reference's criterion: cross-entropy with optional
class weights (torch's weighted-mean reduction) or BCE-with-logits on
one-hot targets, label smoothing, and samples flagged as decode failures
masked out by ``sample_mask``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.models import build_model
from vision_collision_detection_tpu_torch.models.convert import (
    from_flax_params,
    load_npz,
)
from vision_collision_detection_tpu_torch.ops.preprocess import (
    eval_preprocess,
    train_preprocess,
)
from vision_collision_detection_tpu_torch.train.optim import (
    build_optimizer,
    clip_by_global_norm_,
    global_norm,
    set_learning_rate,
)


@dataclass
class TrainState:
    """What the flax ``TrainState`` holds beside the parameters, which live
    in the model: the optimizer (its moments), the schedule, the clip
    norm (0: none) and the count of steps taken."""

    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    grad_clip_norm: float = 0.0
    step: int = 0


def weighted_loss(logits: torch.Tensor, targets: torch.Tensor,
                  class_weights: torch.Tensor, sample_mask: torch.Tensor, *,
                  loss_type: str = "cross_entropy",
                  label_smoothing: float = 0.0):
    """(batch loss, per-sample losses). The batch loss is
    Σ wᵢ·lossᵢ / max(Σ wᵢ, 1e-8), wᵢ = class_weights[targetᵢ]·maskᵢ."""
    num_classes = logits.shape[-1]
    onehot = F.one_hot(targets, num_classes).to(logits.dtype)
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / num_classes
    if loss_type == "cross_entropy":
        per_sample = -(onehot * F.log_softmax(logits, dim=-1)).sum(-1)
    elif loss_type == "bce":
        per_sample = F.binary_cross_entropy_with_logits(
            logits, onehot, reduction="none").mean(-1)
    else:
        raise ValueError(f"unknown loss type {loss_type!r}")
    w = class_weights[targets] * sample_mask
    denom = w.sum().clamp_min(1e-8)
    return (per_sample * w).sum() / denom, per_sample


def load_pretrained_backbone(model: torch.nn.Module, npz_path: str) -> None:
    """Load converted backbone weights (the JAX package's ``.npz``, whose
    ``params`` subtree is the backbone's) into ``model.backbone``, cast to
    the parameters' float32; the heads keep their initial weights. Every
    backbone parameter must be in the file."""
    loaded = load_npz(npz_path)
    if loaded.get("batch_stats"):
        raise NotImplementedError(
            "backbones with batch statistics are not ported yet "
            "(ROADMAP.md, queue 1, item 14)")
    blocks = [m for m in model.backbone.modules()
              if hasattr(m, "use_dwconv_kernel")]
    sd = from_flax_params(loaded["params"], dwconv_kernel=all(
        m.use_dwconv_kernel for m in blocks))
    model.backbone.load_state_dict(sd, strict=True)


def create_train_state(cfg: ExperimentConfig, generator: torch.Generator,
                       steps_per_epoch: int, device=None):
    """→ (model, TrainState). The weights are drawn by ``init_weights`` from
    ``generator`` (a CPU generator: the model is initialised there and
    moved to ``device``, by default the card), then the pretrained backbone
    is loaded where the config names one."""
    model = build_model(cfg.model, device=device, generator=generator,
                        frame_size=cfg.data.frame_size)
    if cfg.model.pretrained_path:
        load_pretrained_backbone(model, cfg.model.pretrained_path)
    opt, schedule = build_optimizer(cfg.optim, model.parameters(),
                                    steps_per_epoch)
    return model, TrainState(opt, schedule, float(cfg.optim.grad_clip_norm))


def _class_weights(class_weights, num_classes, device):
    if class_weights is None:
        return torch.ones(num_classes, device=device)
    return torch.as_tensor(class_weights, dtype=torch.float32, device=device)


def _on(x, device):
    """``x`` (an array or tensor) on ``device``; None stays None."""
    return None if x is None else torch.as_tensor(x).to(device)


def make_train_step(model: torch.nn.Module, cfg: ExperimentConfig,
                    class_weights=None, preprocess: bool = True) -> Callable:
    """→ step(state, frames, targets, sample_mask, generator, sensor=None)
    → (state, {"loss", "accuracy", "grad_norm"}), the metrics 0-d tensors
    on the model's device.

    ``frames``: uint8 [B, T, H, W, 3] when ``preprocess``, else model-ready
    frames. ``generator``: on the model's device; it draws the flips, the
    augmentation, then the dropout masks. The step updates the model's
    parameters and ``state`` in place; ``grad_norm`` is the gradients'
    global norm before clipping. ``sensor`` [B, T_sensor, 4] reaches the
    model where ``cfg.model.use_sensor`` is set and is ignored elsewhere."""
    device = next(model.parameters()).device
    aug_cfg = cfg.augment
    S = cfg.data.frame_size
    cw = _class_weights(class_weights, cfg.model.num_classes, device)
    loss_type = cfg.optim.loss_type
    smoothing = cfg.optim.label_smoothing
    dtype = getattr(torch, cfg.model.dtype)
    params = [p for p in model.parameters() if p.requires_grad]
    use_sensor = cfg.model.use_sensor

    def step(state: TrainState, frames, targets, sample_mask,
             generator: torch.Generator, sensor=None):
        model.train()
        frames = torch.as_tensor(frames).to(device, non_blocking=True)
        targets = torch.as_tensor(targets).to(device, torch.int64)
        sample_mask = torch.as_tensor(sample_mask).to(device, torch.float32)
        if preprocess:
            x = train_preprocess(generator, frames, aug_cfg, S, dtype)
        else:
            x = frames
        extra = {"sensor": _on(sensor, device)} if use_sensor else {}
        state.optimizer.zero_grad(set_to_none=True)
        logits = model(x, generator=generator, **extra)
        loss, _ = weighted_loss(logits, targets, cw, sample_mask,
                                loss_type=loss_type,
                                label_smoothing=smoothing)
        loss.backward()
        grads = [p.grad for p in params]
        if any(g is None for g in grads):
            # the optimizer would skip these parameters without a word
            missing = [n for n, p in model.named_parameters()
                       if p.requires_grad and p.grad is None]
            raise RuntimeError(f"no gradient reached {missing}")
        grad_norm = global_norm(grads)
        if state.grad_clip_norm > 0:
            clip_by_global_norm_(grads, state.grad_clip_norm, grad_norm)
        set_learning_rate(state.optimizer, state.schedule(state.step))
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            preds = logits.argmax(-1)
            correct = ((preds == targets) * sample_mask).sum()
            count = sample_mask.sum().clamp_min(1.0)
        return state, {"loss": loss.detach(), "accuracy": correct / count,
                       "grad_norm": grad_norm}

    return step


def make_eval_step(model: torch.nn.Module, cfg: ExperimentConfig,
                   class_weights=None, preprocess: bool = True) -> Callable:
    """→ step(frames, targets, sample_mask, sensor=None) → {"loss",
    "per_sample_loss", "probs", "preds"} on the model's device, in eval mode
    without gradients; ``sensor`` as in ``make_train_step``."""
    device = next(model.parameters()).device
    aug_cfg = cfg.augment
    S = cfg.data.frame_size
    cw = _class_weights(class_weights, cfg.model.num_classes, device)
    loss_type = cfg.optim.loss_type
    dtype = getattr(torch, cfg.model.dtype)
    use_sensor = cfg.model.use_sensor

    @torch.inference_mode()
    def step(frames, targets, sample_mask,
             sensor=None) -> Dict[str, torch.Tensor]:
        model.eval()
        frames = torch.as_tensor(frames).to(device, non_blocking=True)
        targets = torch.as_tensor(targets).to(device, torch.int64)
        sample_mask = torch.as_tensor(sample_mask).to(device, torch.float32)
        x = eval_preprocess(frames, aug_cfg, S, dtype) if preprocess else frames
        extra = {"sensor": _on(sensor, device)} if use_sensor else {}
        logits = model(x, **extra)
        loss, per_sample = weighted_loss(logits, targets, cw, sample_mask,
                                         loss_type=loss_type)
        return {"loss": loss, "per_sample_loss": per_sample,
                "probs": torch.softmax(logits, dim=-1),
                "preds": logits.argmax(-1)}

    return step
