"""Seeded generators.

Counterpart of ``vision_collision_detection_tpu/utils/rng.py``: every random
decision flows from one root seed → per epoch → per batch → per clip, as
``torch.Generator``s. JAX splits and folds keys; here each generator's seed
is derived from the root seed and its path by a hash, so the tree is the
same on every host and its branches are independent. The draws differ from
the JAX package's: the two generators cannot match.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

import torch


def derive_seed(seed: int, *path) -> int:
    """A 63-bit seed for the node ``path`` (ints and names) under the root
    ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + tuple(path)).encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_rngs(seed: int, names: tuple = ("params", "dropout"),
              device="cpu") -> Dict[str, torch.Generator]:
    """Named generators, the same on every host (seeded identical init)."""
    return {name: _generator(derive_seed(seed, "init", name), device)
            for name in names}


def clip_keys(generator: torch.Generator, batch_size: int,
              device="cpu") -> List[torch.Generator]:
    """One generator per clip, seeded from ``generator``'s next draws."""
    seeds = torch.randint(0, 2 ** 62, (batch_size,), generator=generator,
                          device=generator.device).tolist()
    return [_generator(s, device) for s in seeds]


def epoch_key(seed: int, epoch: int, device="cpu") -> torch.Generator:
    return _generator(derive_seed(seed, "epoch", int(epoch)), device)


def batch_key(seed: int, epoch: int, step: int,
              device="cpu") -> torch.Generator:
    return _generator(derive_seed(seed, "epoch", int(epoch), "step",
                                  int(step)), device)
