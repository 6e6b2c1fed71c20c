"""Optimizer and learning-rate schedule.

Counterpart of ``vision_collision_detection_tpu/train/optim.py`` (optax):

- The schedule is torch's ``CosineAnnealingLR(T_max, eta_min=lr·ratio)``
  semantics: the rate is constant within an epoch and follows the cosine
  per epoch, with an optional linear warmup. The caller sets it per step.
- ``adamw`` is ``torch.optim.AdamW`` with one parameter group, which
  decays every parameter, as ``optax.adamw`` does. With ε = 1e-8 and no
  ``eps_root`` the update is the same function: p − lr·(m̂/(√v̂ + ε) + wd·p),
  with m̂ and v̂ bias-corrected; the two round in other places.
  ``adam`` is ``torch.optim.Adam`` (``optax.adam``) and ``sgd`` is
  ``torch.optim.SGD`` with momentum 0.9 (``optax.sgd(momentum=0.9)``:
  t = g + 0.9·t, p −= lr·t).
- Clipping is ``optax.clip_by_global_norm``: gradients are scaled by
  max/‖g‖ only where ‖g‖ exceeds max (``clip_grad_norm_`` would divide by
  ‖g‖ + 1e-6 and scale below the limit too).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Sequence, Tuple

import torch

from vision_collision_detection_tpu_torch.config import OptimConfig


def cosine_annealing_schedule(base_lr: float, t_max_epochs: int,
                              steps_per_epoch: int, eta_min_ratio: float,
                              warmup_steps: int = 0) -> Callable[[int], float]:
    """step → learning rate: per-epoch cosine annealing, optional linear
    warmup over the first ``warmup_steps`` steps."""
    eta_min = base_lr * eta_min_ratio
    spe = max(1, steps_per_epoch)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (step + 1) / warmup_steps
        epoch = step // spe
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * epoch / t_max_epochs))

    return schedule


def build_optimizer(cfg: OptimConfig, params: Iterable[torch.nn.Parameter],
                    steps_per_epoch: int
                    ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """→ (optimizer over ``params``, schedule). The optimizer's rate is
    the schedule's at step 0 until the caller sets it."""
    if cfg.schedule == "cosine":
        schedule = cosine_annealing_schedule(
            cfg.learning_rate, cfg.cosine_t_max_epochs, steps_per_epoch,
            cfg.eta_min_ratio, cfg.warmup_steps)
    elif cfg.schedule == "constant":
        schedule = lambda step: cfg.learning_rate  # noqa: E731
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    lr = schedule(0)
    params = list(params)
    betas = (cfg.beta1, cfg.beta2)
    if cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=0.9)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return opt, schedule


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """√(Σ ‖g‖²) over every gradient, float32, as ``optax.global_norm``."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """``optax.clip_by_global_norm`` in place: g ← g / ‖g‖ · max where
    ‖g‖ (``norm``) ≥ max, else unchanged; no host synchronisation."""
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
