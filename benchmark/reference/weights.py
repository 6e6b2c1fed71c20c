"""Each configuration's parameters and the seeded laws they are drawn from.

The names and shapes are the program's state-dict keys (the benchmark
loads the same dict into the program and hands it to the reference); the
reference reads them by name in ``models``. The laws make a run's
comparison sensitive: kernels N(0, 1/fan_in), biases N(0, 0.1²), norm
scales 1 + N(0, 0.1²), ConvNeXt layer scales U(0.5, 1.5) (so no block is
an identity), position tables N(0, 0.02²), and the last layer scaled by
the configuration's ``logit_scale`` so that the clips' probabilities are
far from uniform. The GRU's ``bias_hh`` holds only its n gate's bias: the
r and z parts are 0 and stay so (the program's flax-shaped cell has one
bias per gate).

``make_params`` draws everything on the device from one generator in two
calls (one normal, one uniform buffer), in float32, the parameters' type.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, tuple, tuple]]  # (name, shape, law)


def _linear(spec: Spec, name: str, n_in: int, n_out: int, scale=1.0):
    spec.append((f"{name}.weight", (n_out, n_in),
                 ("normal", scale * n_in ** -0.5)))
    spec.append((f"{name}.bias", (n_out,), ("normal", 0.1)))


def _norm(spec: Spec, name: str, n: int):
    spec.append((f"{name}.weight", (n,), ("one_plus", 0.1)))
    spec.append((f"{name}.bias", (n,), ("normal", 0.1)))


def convnext_gru_spec(c: dict) -> Spec:
    dims, depths = c["dims"], c["depths"]
    spec: Spec = []
    b = "backbone"
    spec.append((f"{b}.stem_conv.weight", (dims[0], 3, 4, 4),
                 ("normal", 48 ** -0.5)))
    spec.append((f"{b}.stem_conv.bias", (dims[0],), ("normal", 0.1)))
    _norm(spec, f"{b}.stem_norm", dims[0])
    for stage, depth in enumerate(depths):
        if stage > 0:
            _norm(spec, f"{b}.downsample{stage}_norm", dims[stage - 1])
            spec.append((f"{b}.downsample{stage}_conv.weight",
                         (dims[stage], dims[stage - 1], 2, 2),
                         ("normal", (4 * dims[stage - 1]) ** -0.5)))
            spec.append((f"{b}.downsample{stage}_conv.bias", (dims[stage],),
                         ("normal", 0.1)))
        C = dims[stage]
        for blk in range(depth):
            n = f"{b}.stage{stage}_block{blk}"
            spec.append((f"{n}.gamma", (C,), ("uniform", 0.5, 1.5)))
            spec.append((f"{n}.dwconv.weight", (49, C), ("normal", 49 ** -0.5)))
            spec.append((f"{n}.dwconv.bias", (C,), ("normal", 0.1)))
            _norm(spec, f"{n}.norm", C)
            _linear(spec, f"{n}.pwconv1", C, 4 * C)
            _linear(spec, f"{n}.pwconv2", 4 * C, C)
    _norm(spec, f"{b}.head_norm", dims[-1])
    H, D = c["temporal_hidden"], dims[-1]
    for sfx in ("", "_reverse"):
        g = f"temporal.gru"
        spec.append((f"{g}.weight_ih_l0{sfx}", (3 * H, D), ("normal", D ** -0.5)))
        spec.append((f"{g}.weight_hh_l0{sfx}", (3 * H, H), ("normal", H ** -0.5)))
        spec.append((f"{g}.bias_ih_l0{sfx}", (3 * H,), ("normal", 0.1)))
        spec.append((f"{g}.bias_hh_l0{sfx}", (3 * H,), ("gru_bias_hh", H)))
    _linear(spec, "temporal.proj", 2 * H, H)
    hid = c["classifier_hidden"]
    _linear(spec, "fc1", H, hid)
    _linear(spec, "fc2", hid, hid // 2)
    _linear(spec, "fc_out", hid // 2, c["num_classes"], c["logit_scale"])
    return spec


def _block_spec(spec: Spec, name: str, dim: int, mlp: int):
    _norm(spec, f"{name}.norm1", dim)
    for p in ("query", "key", "value", "out"):
        _linear(spec, f"{name}.attn.{p}", dim, dim)
    _norm(spec, f"{name}.norm2", dim)
    _linear(spec, f"{name}.mlp_fc1", dim, mlp)
    _linear(spec, f"{name}.mlp_fc2", mlp, dim)


def vivit_spec(c: dict) -> Spec:
    dim, P = c["dim"], c["patch_size"]
    n_patches = (c["frame_size"] // P) ** 2
    spec: Spec = [
        ("patch_embed.weight", (dim, 3, P, P), ("normal", (3 * P * P) ** -0.5)),
        ("patch_embed.bias", (dim,), ("normal", 0.1)),
        ("spatial_pos", (n_patches, dim), ("normal", 0.02)),
    ]
    for i in range(c["spatial_layers"]):
        _block_spec(spec, f"spatial_{i}", dim, c["mlp_dim"])
    _norm(spec, "spatial_norm", dim)
    spec.append(("temporal_pos", (c["max_frames"], dim), ("normal", 0.02)))
    for i in range(c["temporal_layers"]):
        _block_spec(spec, f"temporal_{i}", dim, c["mlp_dim"])
    _norm(spec, "temporal_norm", dim)
    _linear(spec, "head", dim, c["num_classes"], c["logit_scale"])
    return spec


SPECS = {"convnext_gru": convnext_gru_spec, "vivit": vivit_spec}


def param_spec(c: dict) -> Spec:
    return SPECS[c["architecture"]](c)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def make_params(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's parameters from ``seed``: float32 tensors on
    ``device``, drawn from one generator there in two calls."""
    spec = param_spec(c)
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
        kind = law[0]
        if kind == "normal":
            t = z * law[1]
        elif kind == "one_plus":
            t = 1.0 + z * law[1]
        elif kind == "uniform":
            t = law[1] + (law[2] - law[1]) * u
        elif kind == "gru_bias_hh":
            t = z * 0.1
            t[: 2 * law[1]] = 0.0
        else:
            raise ValueError(f"unknown law {law!r}")
        out[name] = t.contiguous()
    return out
