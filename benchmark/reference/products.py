"""The reference's products, in the precision a comparison asks for.

``Products("float32")`` computes every product in float32, with TF32 off
(``float32_math``). ``Products("fp8")`` is the control: the reference
computed one step below the configurations' bf16, as a later change might
be tempted to compute it. Where the program rounds to bf16, this rounds to
float8 e4m3 under a per-tensor scale (its largest magnitude to the
format's largest value): each operand and each result of a product that
the configuration states in bf16, the model's input frames, and the
residual stream after each block (``act``); in a backward, the gradient
arriving at each of those results is rounded to float8 e5m2 likewise, the
usual recipe of fp8 training, and the rounding of an operand passes its
gradient through unchanged. The sums inside a product, the norms'
statistics and the softmax stay float32, as in the program; the products
the configuration states in float32 (the GRU, the last layer) take
``Products("float32")`` in both.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


@contextlib.contextmanager
def float32_math():
    """TF32 off for matrix products and cuDNN convolutions."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_fp8(t: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """``t``'s values rounded to ``fmt`` under a per-tensor scale, in
    float32 (no gradient of its own)."""
    t = t.detach()
    scale = t.abs().amax().float().clamp_min(1e-30) / FP8[fmt]
    return (t / scale).to(fmt).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Values rounded to e4m3; the gradient rounded to e5m2 where
    ``grad`` (a result), passed through where not (an operand)."""

    @staticmethod
    def forward(ctx, t, grad):
        ctx.grad = grad
        return round_fp8(t)

    @staticmethod
    def backward(ctx, g):
        return (round_fp8(g, torch.float8_e5m2) if ctx.grad else g), None


class Products:
    KINDS = ("float32", "fp8")

    def __init__(self, kind: str = "float32"):
        if kind not in self.KINDS:
            raise ValueError(f"kind {kind!r} not in {self.KINDS}")
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of a product."""
        return t if self.kind == "float32" else _Fp8.apply(t, False)

    def act(self, y: torch.Tensor) -> torch.Tensor:
        """A result the program keeps in bf16: a product's, the input
        frames, the residual stream."""
        return y if self.kind == "float32" else _Fp8.apply(y, True)

    def linear(self, x, w, b=None):
        return self.act(F.linear(self.q(x), self.q(w), b))

    def matmul(self, a, b):
        return self.act(torch.matmul(self.q(a), self.q(b)))

    def conv2d(self, x, w, b=None, stride=1, padding=0, groups=1):
        return self.act(F.conv2d(self.q(x), self.q(w), b, stride, padding, 1,
                                 groups))


FLOAT32 = Products("float32")
