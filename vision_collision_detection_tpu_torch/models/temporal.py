"""Temporal aggregation heads over per-frame features [B, T, D] → [B, D_out].

Counterpart of ``vision_collision_detection_tpu/models/temporal.py``. Only
the flagship head is ported so far: the bidirectional GRU. The attention,
conv, pooling, rnn and lstm heads are queued for the port's later slices
(see ROADMAP.md, queue 1, item 4).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

_LATER = ("temporal mode {!r} is not ported yet: the port's first slice "
          "carries the GRU head only; the others come with a later PR "
          "(ROADMAP.md, queue 1, item 4)")


class TemporalRNN(nn.Module):
    """GRU over time in float32; the output is the last forward state,
    concatenated with the first backward state when bidirectional, then
    ``proj`` and ReLU.

    ``nn.GRU`` computes the same cell as the JAX package's ``_HoistedGRU``:
    flax's ``hn`` bias sits inside ``r * (...)``, which is torch's
    ``b_hn``; the ``hr``/``hz`` products have no bias (``b_hr = b_hz = 0``).
    Those two have no flax counterpart, so training keeps them at zero: a
    hook drops their part of ``bias_hh``'s gradient.

    The recurrence runs in float32 math: cuDNN's TF32 is off around the GRU
    forward and around its backward node (``_Float32Pin``), whatever the
    caller set, and the caller's flags are restored after each.
    """

    def __init__(self, dim: int, hidden: int = 256, cell_type: str = "gru",
                 bidirectional: bool = True):
        super().__init__()
        if cell_type != "gru":
            raise NotImplementedError(_LATER.format(cell_type))
        self.hidden = hidden
        self.bidirectional = bidirectional
        self.gru = nn.GRU(dim, hidden, batch_first=True,
                          bidirectional=bidirectional)
        self.proj = nn.Linear(hidden * (2 if bidirectional else 1), hidden)
        for name, p in self.gru.named_parameters():
            if name.startswith("bias_hh"):
                p.register_hook(_hn_bias_only)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with _Float32Pin():
            out, _ = self.gru(x.to(torch.float32))
        if out.grad_fn is not None:  # on the card, cuDNN's RNN node
            _Float32Pin().around(out.grad_fn)
        H = self.hidden
        last = out[:, -1, :H]
        if self.bidirectional:
            last = torch.cat([last, out[:, 0, H:]], dim=-1)
        return F.relu(self.proj(last))


class _Float32Pin:
    """cuDNN's TF32 off while it is entered, through the legacy
    ``torch.backends.cudnn.allow_tf32`` switch (the one ``chip_smoke.py``
    sets), and the caller's flags restored on exit. Where the caller set
    cuDNN's conv and RNN precisions apart through torch's per-operator
    ``fp32_precision`` flags, the legacy getter raises; those two flags are
    what is restored then."""

    def __enter__(self):
        cudnn = torch.backends.cudnn
        try:
            self._saved = cudnn.allow_tf32
        except RuntimeError:
            self._saved = (cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision)
        cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        cudnn = torch.backends.cudnn
        if isinstance(self._saved, tuple):
            cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision = self._saved
        else:
            cudnn.allow_tf32 = self._saved

    def around(self, node) -> None:
        """Pin the flags while the autograd ``node`` runs: the backward reads
        them when it runs, not when the forward did."""
        def pre(grad_outputs):
            self.__enter__()

        def post(grad_inputs, grad_outputs):
            self.__exit__()

        node.register_prehook(pre)
        node.register_hook(post)


def _hn_bias_only(grad: torch.Tensor) -> torch.Tensor:
    """``bias_hh``'s gradient [b_hr, b_hz, b_hn] with the r and z parts
    zeroed."""
    n = grad.shape[0] // 3
    return torch.cat([torch.zeros_like(grad[:2 * n]), grad[2 * n:]])


def build_temporal_head(mode: str, dim: int, *, hidden: int = 256,
                        num_heads: int = 4, max_seq_length: int = 30,
                        bidirectional: bool = True, dropout: float = 0.0):
    if mode == "gru":
        return TemporalRNN(dim, hidden=hidden, cell_type=mode,
                           bidirectional=bidirectional)
    if mode in ("attention", "conv", "pooling", "rnn", "lstm"):
        raise NotImplementedError(_LATER.format(mode))
    raise ValueError(f"unknown temporal mode {mode!r}")


def temporal_out_dim(mode: str, dim: int, hidden: int) -> int:
    if mode in ("attention", "pooling"):
        return dim
    if mode in ("conv", "rnn", "lstm", "gru"):
        return hidden
    raise ValueError(f"unknown temporal mode {mode!r}")
