"""The reference's training step, and the replay of a training cell's first
steps.

What the program draws, the replay draws again from the same seeds by the
same rules, frozen here: the loader's epoch shuffle (``epoch_order``, a
permutation from ``numpy.random.default_rng((seed, epoch))``), each step's
generator seed (``step_seed``: SHA-256 of the root seed and the step's
path), and in each step the flips and augmentation (``preprocess``) and
then the two dropout masks (``models.dropout``).

The loss is the class-weighted cross-entropy over the clips whose mask is
set (inverse-frequency weights of the training set's labels). AdamW
decays every parameter: p ← p(1 − lr·wd) − lr·m̂/(√v̂ + ε), m̂ and v̂
bias-corrected, the rate per epoch on a cosine from ``learning_rate`` to
``learning_rate·eta_min_ratio`` over ``cosine_t_max_epochs`` epochs. A
parameter's part that the architecture freezes (its ``frozen_mask``) takes
no gradient.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import architectures
from benchmark.reference import models
from benchmark.reference.preprocess import train_frames
from benchmark.reference.products import FLOAT32, Products, float32_math


def derive_seed(seed: int, *path) -> int:
    h = hashlib.sha256(repr((int(seed),) + tuple(path)).encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def step_seed(seed: int, epoch: int, step: int, rank: int = 0) -> int:
    return derive_seed(seed, epoch * 131071 + step, rank)


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    return np.random.default_rng((seed, epoch)).permutation(np.arange(n))


def class_weights(labels, num_classes: int) -> np.ndarray:
    counts = np.bincount(np.asarray(labels, np.int64), minlength=num_classes)
    w = np.where(counts > 0, counts.sum() / np.maximum(counts, 1) / num_classes,
                 0.0)
    return w.astype(np.float32)


def learning_rate(o: dict, step: int, steps_per_epoch: int) -> float:
    base = o["learning_rate"]
    if step < o["warmup_steps"]:
        return base * (step + 1) / o["warmup_steps"]
    eta_min = base * o["eta_min_ratio"]
    epoch = step // max(1, steps_per_epoch)
    return eta_min + (base - eta_min) * 0.5 * (
        1.0 + math.cos(math.pi * epoch / o["cosine_t_max_epochs"]))


def weighted_ce(logits, targets, weights, mask):
    per = -(F.one_hot(targets, logits.shape[-1]).float()
            * F.log_softmax(logits, dim=-1)).sum(-1)
    w = weights[targets] * mask
    return (per * w).sum() / w.sum().clamp_min(1e-8)


def replay(P0: Dict[str, torch.Tensor], c: dict, batches: List[tuple],
           seeds: List[int], weights: torch.Tensor, steps_per_epoch: int,
           prec: Products = FLOAT32) -> dict:
    """The program's first ``len(batches)`` steps from ``P0``: each batch
    (uint8 frames, int64 targets, float32 mask) under its step's generator
    seed. → the losses, each leaf's first gradient norm and each leaf's
    change over the steps (device tensors)."""
    o, a = c["optim"], c["augment"]
    names = list(P0)
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    m = {k: torch.zeros_like(v) for k, v in P0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P0.items()}
    arch = architectures.get(c["architecture"])
    masks = {k: arch.frozen_mask(k, c) for k in names}
    b1, b2, eps, wd = o["beta1"], o["beta2"], 1e-8, o["weight_decay"]
    losses, first_grad = [], None
    with float32_math():
        for i, ((frames, targets, mask), seed) in enumerate(zip(batches, seeds)):
            gen = torch.Generator(device=frames.device).manual_seed(seed)
            x = train_frames(gen, frames, a, c["frame_size"])
            z = models.logits(P, x, c, prec, training=True, generator=gen,
                              ckpt=True)
            loss = weighted_ce(z, targets, weights, mask)
            grads = torch.autograd.grad(loss, [P[k] for k in names])
            del x, z
            lr = learning_rate(o, i, steps_per_epoch)
            t = i + 1
            with torch.no_grad():
                for k, g in zip(names, grads):
                    if masks[k] is not None:
                        g = g * masks[k].to(g.device)
                    if i == 0:
                        first_grad = first_grad or {}
                        first_grad[k] = g.norm()
                    p = P[k]
                    p.mul_(1.0 - lr * wd)
                    m[k].lerp_(g, 1.0 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    denom = (v2[k].sqrt() / math.sqrt(1.0 - b2 ** t)).add_(eps)
                    p.addcdiv_(m[k], denom, value=-lr / (1.0 - b1 ** t))
            losses.append(loss.detach())
            del grads
    change = {k: (P[k].detach() - P0[k]).norm() for k in names}
    return {"losses": torch.stack(losses), "first_grad": first_grad,
            "change": change}
