"""Each configuration's parameters and the seeded laws they are drawn from.

The names, shapes and laws come from the configuration's architecture
(``architectures.get(c["architecture"]).param_spec``); the names and
shapes are the program's state-dict keys (the benchmark loads the same
dict into the program and hands it to the reference), which the reference
reads by name. The laws make a run's comparison sensitive: kernels
N(0, 1/fan_in), biases N(0, 0.1²), norm scales 1 + N(0, 0.1²), and the
last layer scaled by the configuration's ``logit_scale`` so that the
clips' probabilities are far from uniform; an architecture adds laws of
its own in its ``LAWS``.

``make_params`` draws everything on the device from one generator in two
calls (one normal, one uniform buffer), in float32, the parameters' type.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark import architectures

Spec = List[Tuple[str, tuple, tuple]]  # (name, shape, law)

# law kind → (normal draws z, uniform draws u, the law's arguments) → tensor
LAWS = {
    "normal": lambda z, u, std: z * std,
    "one_plus": lambda z, u, std: 1.0 + z * std,
    "uniform": lambda z, u, lo, hi: lo + (hi - lo) * u,
}


def linear_spec(spec: Spec, name: str, n_in: int, n_out: int, scale=1.0):
    spec.append((f"{name}.weight", (n_out, n_in),
                 ("normal", scale * n_in ** -0.5)))
    spec.append((f"{name}.bias", (n_out,), ("normal", 0.1)))


def norm_spec(spec: Spec, name: str, n: int):
    spec.append((f"{name}.weight", (n,), ("one_plus", 0.1)))
    spec.append((f"{name}.bias", (n,), ("normal", 0.1)))


def param_spec(c: dict) -> Spec:
    return architectures.get(c["architecture"]).param_spec(c)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def make_params(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's parameters from ``seed``: float32 tensors on
    ``device``, drawn from one generator there in two calls."""
    arch = architectures.get(c["architecture"])
    laws = dict(LAWS, **getattr(arch, "LAWS", {}))
    spec = arch.param_spec(c)
    total = sum(_numel(s) for _, s, _ in spec)
    g = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, law in spec:
        n = _numel(shape)
        z = normal[at:at + n].view(shape)
        u = uniform[at:at + n].view(shape)
        at += n
        if law[0] not in laws:
            raise ValueError(f"unknown law {law!r}")
        out[name] = laws[law[0]](z, u, *law[1:]).contiguous()
    return out
