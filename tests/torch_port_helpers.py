"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded flax parameter trees with every leaf randomised, and a
fixture that limits torch's threads."""

from __future__ import annotations

import numpy as np
import pytest
import torch


def randomize_params(tree, rng: np.random.Generator):
    """Every leaf of a flax parameter tree redrawn from ``rng``: kernels
    normal with variance 1/fan_in, biases N(0, 0.1²), LayerNorm scales
    1 + N(0, 0.1²), layer-scale γ uniform in [0.5, 1.5] (order 1, so no
    block is close to the identity)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = randomize_params(dict(v), rng)
            continue
        a = np.asarray(v)
        if k == "gamma":
            r = rng.uniform(0.5, 1.5, a.shape)
        elif k == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            r = rng.normal(0.0, fan_in ** -0.5, a.shape)
        elif k == "scale":
            r = 1.0 + 0.1 * rng.normal(size=a.shape)
        else:
            r = 0.1 * rng.normal(size=a.shape)
        out[k] = r.astype(np.float32)
    return out


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at each |x| (8 significant bits)."""
    mag = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """The test workers share the host's cores: two intra-op threads each
    keep torch's thread pools from oversubscribing them (the port's tests
    at convnext_tiny run on small tensors, where more threads buy little).
    Imported by a test module, it holds for that module's tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
