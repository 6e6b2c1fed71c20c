"""The reference's temporal heads, for imported reference checkpoints.

Counterpart of ``vision_collision_detection_tpu/models/reference_heads.py``:
the math of the reference's temporal modules, operation for operation, so
that an imported ``EnhancedFrameCNN`` checkpoint gives the reference's
logits. Every head maps [B, T, D] → [B, D]:

- ``RefTemporalAttention``: LayerNorm (eps 1e-5) → + position table →
  multi-head self-attention with torch's packed-QKV semantics, written out
  over ``query``/``key``/``value``/``out`` projections (as the JAX head
  computes it; the softmax weights stay in ``last_attention_weights``) →
  mean over T. No residual, no post-norm.
- convolution: (Conv1d D → D, BatchNorm (eps 1e-5), ReLU) twice → mean
  over T, which is ``temporal.TemporalConvolution`` at hidden = D;
- pooling: mean over T, ``temporal.AdaptivePooling``.
- ``RefTemporalRNN``: LayerNorm (eps 1e-5) → a stacked, optionally
  bidirectional ``nn.GRU``/``nn.LSTM``/``nn.RNN`` named ``rnn`` (the
  reference's own module, so its keys are the reference's) → the last
  layer's final hidden states (forward, backward) → ``projection`` back to
  D where the widths differ. The recurrence runs in float32 without TF32
  whatever the model's dtype (the JAX head runs its cells in the model's
  dtype).

These are not the performance heads of ``temporal.py``; they exist so that
reference training checkpoints serve with the reference's numbers.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vision_collision_detection_tpu_torch.models.backbones.convnext import (
    layer_norm,
    linear,
)
from vision_collision_detection_tpu_torch.models.temporal import (
    _RNN_CLASSES,
    AdaptivePooling,
    TemporalConvolution,
    attention_weights,
    mean_over_time,
)
from vision_collision_detection_tpu_torch.utils.precision import cudnn_float32

TORCH_EPS = 1e-5  # torch's LayerNorm and BatchNorm default


class RefTemporalAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 4, max_seq_length: int = 30,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.max_seq_length = max_seq_length
        self.dtype = dtype
        self.norm = nn.LayerNorm(dim, eps=TORCH_EPS)
        self.pos_embedding = nn.Parameter(torch.zeros(max_seq_length, dim))
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.last_attention_weights: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, D = x.shape
        if T > self.max_seq_length:
            raise ValueError(f"sequence length {T} exceeds "
                             f"max_seq_length={self.max_seq_length}")
        dt = self.dtype
        H = self.num_heads
        h = layer_norm(x, self.norm, dt) + self.pos_embedding[:T].to(dt)

        def heads(fc):
            return linear(h, fc, dt).reshape(B, T, H, D // H).transpose(1, 2)

        attn = attention_weights(heads(self.query), heads(self.key))
        self.last_attention_weights = attn.detach()
        out = torch.matmul(attn.to(dt), heads(self.value))
        out = linear(out.transpose(1, 2).reshape(B, T, D), self.out, dt)
        return mean_over_time(out, dt)


class RefTemporalRNN(nn.Module):
    def __init__(self, dim: int, hidden: int = 512, cell_type: str = "gru",
                 num_layers: int = 2, bidirectional: bool = True,
                 dtype=torch.float32):
        super().__init__()
        if cell_type not in _RNN_CLASSES:
            raise ValueError(f"unknown cell_type {cell_type!r}")
        self.dtype = dtype
        self.bidirectional = bidirectional
        self.norm = nn.LayerNorm(dim, eps=TORCH_EPS)
        self.rnn = _RNN_CLASSES[cell_type](
            dim, hidden, num_layers=num_layers, batch_first=True,
            bidirectional=bidirectional)
        out_dim = hidden * (2 if bidirectional else 1)
        if out_dim != dim:
            self.projection = nn.Linear(out_dim, dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        h = layer_norm(x, self.norm, dt).to(torch.float32)
        _, state = cudnn_float32(self.rnn, h)
        hidden = state[0] if isinstance(state, tuple) else state  # LSTM: (h, c)
        # the last layer's final states: forward after x[T-1], backward
        # after x[0]
        last = (torch.cat([hidden[-2], hidden[-1]], dim=-1)
                if self.bidirectional else hidden[-1])
        if hasattr(self, "projection"):
            last = linear(last, self.projection, dt)
        return last.to(torch.float32)


def build_reference_head(mode: str, dim: int, *, num_heads: int = 4,
                         kernel: int = 3, rnn_hidden: int = 512,
                         rnn_layers: int = 2, bidirectional: bool = True,
                         max_seq_length: int = 30, dtype=torch.float32):
    """The reference's head selection; ``convolution`` and ``conv`` name
    the same head. Every mode outputs [B, dim]."""
    if mode == "attention":
        return RefTemporalAttention(dim, num_heads=num_heads,
                                    max_seq_length=max_seq_length,
                                    dtype=dtype)
    if mode in ("convolution", "conv"):
        return TemporalConvolution(dim, hidden=dim, kernel=kernel,
                                   dtype=dtype)
    if mode == "pooling":
        return AdaptivePooling()
    if mode in _RNN_CLASSES:
        return RefTemporalRNN(dim, hidden=rnn_hidden, cell_type=mode,
                              num_layers=rnn_layers,
                              bidirectional=bidirectional, dtype=dtype)
    raise ValueError(f"unknown temporal mode {mode!r}")
