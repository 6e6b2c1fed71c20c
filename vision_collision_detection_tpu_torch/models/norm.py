"""BatchNorm with flax's semantics, over the last axis.

Counterpart of flax's ``nn.BatchNorm`` as the JAX package's modules call it
(feature axis last: NHWC maps, [B, T, C] sequences, [B, C] rows). It
differs from ``torch.nn.BatchNorm*d`` in four ways, each of which would make
a model train away from the JAX package:

- the running variance is updated with the **biased** batch variance (the
  one the batch is normalised with), where torch uses the unbiased one;
- ``momentum`` is flax's: ``running = m·running + (1 − m)·batch``, so the
  JAX package's 0.9 stays 0.9 here (torch would call it 0.1);
- ``eps`` is whatever the JAX call site gives (1e-5 or 1e-3);
- the statistics are reduced in float32 whatever the compute dtype, with
  flax's fast variance E[x²] − E[x]² clipped at 0, and the result is cast
  to the compute dtype.

The mode is ``nn.Module``'s: in training (``self.training``) the batch's
statistics normalise it and update the running ones, once per forward;
in eval the running statistics normalise. There is no
``num_batches_tracked``: flax keeps no counter and the momentum is fixed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        """``dtype``: the compute dtype of the output (None: the input's)."""
        super().__init__()
        self.num_features = num_features
        self.momentum = float(momentum)
        self.eps = float(eps)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.dtype or x.dtype
        xf = x.to(torch.float32)
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(out_dtype)
