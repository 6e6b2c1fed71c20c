"""float32 math in cuDNN whatever the caller's TF32 flags.

torch lets cuDNN's float32 convolutions and recurrences run in TF32 by
default (``torch.backends.cudnn.allow_tf32`` is True), which rounds their
products to 10 bits of mantissa. The JAX package computes them in float32,
so the port's float32 convolutions and RNNs run inside ``Float32Pin``: TF32
off for their forward and for their backward node, the caller's flags
restored after each.
"""

from __future__ import annotations

import torch


class Float32Pin:
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


def cudnn_float32(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with cuDNN's TF32 off around it and around
    the backward node of its (first) output."""
    with Float32Pin():
        out = fn(*args, **kwargs)
    first = out[0] if isinstance(out, tuple) else out
    if first.grad_fn is not None:  # on the card, cuDNN's node
        Float32Pin().around(first.grad_fn)
    return out
