"""The reference forward of a configuration, in plain PyTorch, as a
function of a parameter dict (``weights.param_spec``'s names) and of
``Products``: ``logits`` hands the frames to the configuration's
architecture (``benchmark/architectures/``), whose forward is built from
the pieces here, shared by every architecture.

Every activation is float32. ``prec`` computes the products the
configurations state in bf16 and rounds what the program keeps in bf16
(``Products.act``); recurrences and the last layer take float32.
``ckpt`` recomputes each block in the backward (``torch.utils.checkpoint``),
so that a float32 step at the timed sizes fits the card; it changes no
value.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark import architectures
from benchmark.reference.products import FLOAT32, Products

LN_EPS = 1e-6


def layer_norm(x, P, name):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"],
                        P[name + ".bias"], LN_EPS)


def linear(prec: Products, x, P, name):
    return prec.linear(x, P[name + ".weight"], P[name + ".bias"])


def gelu(x):
    return F.gelu(x, approximate="tanh")


def dropout(h, rate, generator):
    """Inverted dropout, its mask drawn as the program draws it."""
    if generator is None or rate == 0.0:
        return h
    keep = 1.0 - rate
    mask = torch.bernoulli(torch.full(h.shape, keep, device=h.device),
                           generator=generator)
    return torch.where(mask.bool(), h / keep, torch.zeros_like(h))


def _run(block, x, ckpt):
    if ckpt and torch.is_grad_enabled():
        return checkpoint(block, x, use_reentrant=False)
    return block(x)


def logits(P, frames, c, prec: Products = FLOAT32, training=False,
           generator=None, ckpt=False):
    """The configuration's forward, its architecture's ``logits`` on the
    frames as the program keeps them: serving (folded frames, no dropout)
    or training (the model's own fold, dropout from ``generator``)."""
    return architectures.get(c["architecture"]).logits(
        P, prec.act(frames), c, prec, training, generator, ckpt)
