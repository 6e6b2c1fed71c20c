"""Temporal aggregation heads over per-frame features [B, T, D] → [B, D_out].

Counterpart of ``vision_collision_detection_tpu/models/temporal.py``:

- ``attention``: a learnable position table, multi-head self-attention
  written out as the flax head computes it (its softmax weights kept in
  ``last_attention_weights``), a residual LayerNorm, then the mean over T;
- ``conv``: two temporal convolutions, each with flax's BatchNorm and a
  ReLU, then the mean over T;
- ``pooling``: the mean over T;
- ``rnn``, ``lstm``, ``gru``: a recurrence in float32, optionally
  bidirectional, the last states concatenated, then ``proj`` and ReLU.

Every head takes ``generator`` beside the features; only the attention
head's dropout draws from it (in training, with ``dropout`` > 0).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vision_collision_detection_tpu_torch.models.backbones.convnext import (
    layer_norm,
    linear,
)
from vision_collision_detection_tpu_torch.models.norm import BatchNorm
from vision_collision_detection_tpu_torch.utils.precision import cudnn_float32


def mean_over_time(h: torch.Tensor, dtype) -> torch.Tensor:
    """``jnp.mean(h, axis=1)`` of an array in ``dtype``: a float32 sum, the
    result rounded to ``dtype``, returned as float32."""
    return h.to(torch.float32).mean(dim=1).to(dtype).to(torch.float32)


def dropout(h: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            training: bool) -> torch.Tensor:
    """flax ``nn.Dropout``: in training (and at a rate above 0) kept values
    scaled by 1/keep, the mask drawn from ``generator``, the result in h's
    dtype; else h."""
    if not training or rate == 0.0:
        return h
    if generator is None:
        raise ValueError("dropout in training draws its masks from a "
                         "generator; pass generator=")
    keep = 1.0 - rate
    mask = torch.bernoulli(torch.full(h.shape, keep, device=h.device),
                           generator=generator)
    return torch.where(mask.bool(), h / keep, torch.zeros_like(h)).to(h.dtype)


def attention_weights(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/√dh) in float32 over [B, H, T, dh] heads: the products
    of the compute-dtype values summed in float32, as flax's einsum with
    ``preferred_element_type=float32``."""
    dh = q.shape[-1]
    logits = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2))
    return torch.softmax(logits / math.sqrt(dh), dim=-1)


class TemporalAttention(nn.Module):
    """JAX ``TemporalAttention``: h = x + pos[:T]; q, k, v, out projections
    (flax ``Dense`` each); probabilities in float32, kept after each
    forward in ``last_attention_weights`` [B, H, T, T] (the JAX head sows
    them for the attention view); LayerNorm(out + x); mean over T."""

    def __init__(self, dim: int, num_heads: int = 4, max_seq_length: int = 30,
                 dropout: float = 0.0, dtype=torch.bfloat16):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.dim = dim
        self.num_heads = num_heads
        self.max_seq_length = max_seq_length
        self.dropout = float(dropout)
        self.dtype = dtype
        self.pos_embedding = nn.Parameter(torch.zeros(max_seq_length, dim))
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.last_attention_weights: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, D = x.shape
        if T > self.max_seq_length:
            raise ValueError(f"sequence length {T} exceeds "
                             f"max_seq_length={self.max_seq_length}")
        dt = self.dtype
        H = self.num_heads
        h = x.to(dt) + self.pos_embedding[:T].to(dt)

        def heads(fc):
            return linear(h, fc, dt).reshape(B, T, H, D // H).transpose(1, 2)

        attn = attention_weights(heads(self.query), heads(self.key))
        self.last_attention_weights = attn.detach()
        attn_c = dropout(attn.to(dt), self.dropout, generator, self.training)
        out = torch.matmul(attn_c, heads(self.value))
        out = linear(out.transpose(1, 2).reshape(B, T, D), self.out, dt)
        h = layer_norm(out + x.to(dt), self.norm, dt)
        return mean_over_time(h, dt)


def conv_time(h: torch.Tensor, conv: nn.Conv1d, dtype) -> torch.Tensor:
    """flax ``nn.Conv`` over T of [B, T, C] (``padding=kernel//2``) in
    ``dtype``; [B, T, C_out]. A float32 convolution runs without TF32."""
    def conv1d(a):
        return F.conv1d(a, conv.weight.to(dtype), conv.bias.to(dtype),
                        padding=conv.padding)

    a = h.to(dtype).transpose(1, 2)
    y = cudnn_float32(conv1d, a) if dtype == torch.float32 else conv1d(a)
    return y.transpose(1, 2)


class TemporalConvolution(nn.Module):
    """JAX ``TemporalConvolution``: (Conv over T → BatchNorm (momentum 0.9,
    eps 1e-5) → ReLU) twice, then the mean over T."""

    def __init__(self, dim: int, hidden: int = 256, kernel: int = 3,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv1d(dim, hidden, kernel, padding=kernel // 2)
        self.bn1 = BatchNorm(hidden, momentum=0.9, eps=1e-5, dtype=dtype)
        self.conv2 = nn.Conv1d(hidden, hidden, kernel, padding=kernel // 2)
        self.bn2 = BatchNorm(hidden, momentum=0.9, eps=1e-5, dtype=dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        h = F.relu(self.bn1(conv_time(x, self.conv1, dt)))
        h = F.relu(self.bn2(conv_time(h, self.conv2, dt)))
        return mean_over_time(h, dt)


class AdaptivePooling(nn.Module):
    """JAX ``AdaptivePooling``: the mean of the float32 features over T."""

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return x.to(torch.float32).mean(dim=1)


_RNN_CLASSES = {"gru": nn.GRU, "lstm": nn.LSTM, "rnn": nn.RNN}


class TemporalRNN(nn.Module):
    """The recurrence over time in float32; the output is the last forward
    state, concatenated with the first backward state when bidirectional,
    then ``proj`` and ReLU. The torch module is named after the cell
    (``gru``, ``lstm``, ``rnn``).

    Each torch cell computes its flax cell's math; flax keeps one bias per
    gate where torch has ``b_ih`` and ``b_hh``, so training keeps the extra
    one at zero with a hook that drops its gradient:
    - GRU (the JAX ``_HoistedGRU``): flax's ``hn`` bias sits inside
      ``r * (...)``, which is torch's ``b_hn``; ``b_hr`` and ``b_hz`` stay 0;
    - LSTM (flax ``OptimizedLSTMCell``, gates i, f, g, o): the biases are
      the hidden side's, so ``b_ih`` stays 0;
    - RNN (flax ``SimpleCell``, tanh): the bias is the input side's, so
      ``b_hh`` stays 0.

    The recurrence runs in float32 math: cuDNN's TF32 is off around the
    forward and around its backward node, whatever the caller set.
    """

    def __init__(self, dim: int, hidden: int = 256, cell_type: str = "gru",
                 bidirectional: bool = True):
        super().__init__()
        if cell_type not in _RNN_CLASSES:
            raise ValueError(f"unknown cell_type {cell_type!r}")
        self.cell_type = cell_type
        self.hidden = hidden
        self.bidirectional = bidirectional
        self.add_module(cell_type, _RNN_CLASSES[cell_type](
            dim, hidden, batch_first=True, bidirectional=bidirectional))
        self.proj = nn.Linear(hidden * (2 if bidirectional else 1), hidden)
        frozen = {"gru": ("bias_hh", _hn_bias_only),
                  "lstm": ("bias_ih", _no_grad),
                  "rnn": ("bias_hh", _no_grad)}[cell_type]
        for name, p in self.recurrence.named_parameters():
            if name.startswith(frozen[0]):
                p.register_hook(frozen[1])

    @property
    def recurrence(self) -> nn.RNNBase:
        return getattr(self, self.cell_type)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out, _ = cudnn_float32(self.recurrence, x.to(torch.float32))
        H = self.hidden
        last = out[:, -1, :H]
        if self.bidirectional:
            last = torch.cat([last, out[:, 0, H:]], dim=-1)
        return F.relu(self.proj(last))


def _hn_bias_only(grad: torch.Tensor) -> torch.Tensor:
    """``bias_hh``'s gradient [b_hr, b_hz, b_hn] with the r and z parts
    zeroed."""
    n = grad.shape[0] // 3
    return torch.cat([torch.zeros_like(grad[:2 * n]), grad[2 * n:]])


def _no_grad(grad: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(grad)


def build_temporal_head(mode: str, dim: int, *, hidden: int = 256,
                        num_heads: int = 4, max_seq_length: int = 30,
                        bidirectional: bool = True, dropout: float = 0.0,
                        dtype=torch.bfloat16):
    """The head of ``mode``; ``dtype`` is the compute dtype of the
    attention and conv heads (the recurrences run in float32)."""
    if mode == "attention":
        return TemporalAttention(dim, num_heads=num_heads,
                                 max_seq_length=max_seq_length,
                                 dropout=dropout, dtype=dtype)
    if mode == "conv":
        return TemporalConvolution(dim, hidden=hidden, dtype=dtype)
    if mode == "pooling":
        return AdaptivePooling()
    if mode in _RNN_CLASSES:
        return TemporalRNN(dim, hidden=hidden, cell_type=mode,
                           bidirectional=bidirectional)
    raise ValueError(f"unknown temporal mode {mode!r}")


def temporal_out_dim(mode: str, dim: int, hidden: int) -> int:
    if mode in ("attention", "pooling"):
        return dim
    if mode in ("conv", "rnn", "lstm", "gru"):
        return hidden
    raise ValueError(f"unknown temporal mode {mode!r}")
