"""The data and model process groups, and the process lifecycle.

Counterpart of ``vision_collision_detection_tpu/parallel/mesh.py``. The JAX
package runs one process per host over that host's devices; the port runs
one process per device, launched as ``torchrun`` launches them: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in the
environment (``env://``).

The JAX ``("data", "model")`` mesh becomes two families of process groups.
The model axis is innermost: rank = data_index · n_model + model_index. A
rank's **data group** holds the ranks of its model index: they hold the
same weights (or the same shards of them) and sum their gradients. Its
**model group** holds the ranks of its data index: they read the same batch
and split the ViViT's heads and MLP (``parallel/tp.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from vision_collision_detection_tpu_torch.config import MeshConfig
from vision_collision_detection_tpu_torch.utils.distributed import (  # noqa: F401
    sync_global_devices,
)

DATA_AXIS = "data"
MODEL_AXIS = "model"

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def maybe_initialize_distributed(backend: Optional[str] = None) -> None:
    """Join the process group when launched by ``torchrun`` (its variables
    set); a no-op without them or when the group exists already.

    The rank's device is card ``LOCAL_RANK`` where a card exists (made the
    current device), else the CPU. ``backend``: NCCL for a card, gloo for
    the CPU unless given (gloo also moves CUDA tensors: two ranks that share
    one card need it, since NCCL refuses two ranks on one device). Ends
    with a one-element all-reduce while every process is at the same point,
    so the backend's connections are made here and not deep inside the
    first training step (the JAX package's warm-up, ``mesh.py:50-67``)."""
    if not all(os.environ.get(k) for k in _TORCHRUN_ENV):
        return
    if dist.is_initialized():
        return
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend or ("nccl" if cuda else "gloo"), init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    dist.all_reduce(torch.zeros(1, device=collective_device()))


def collective_device(group=None) -> torch.device:
    """Where a collective of ``group`` takes its tensors: the current card
    for NCCL, the CPU for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def mesh_shape(cfg: Optional[MeshConfig], world_size: int) -> Tuple[int, int]:
    """→ (n_data, n_model) of ``cfg`` over ``world_size`` ranks: the model
    axis 1 by default, the data axis the rest unless given; a shape that
    does not cover the world raises ``ValueError``."""
    cfg = cfg or MeshConfig()
    n_model = max(1, cfg.num_model)
    n_data = cfg.num_data if cfg.num_data > 0 else world_size // n_model
    if n_data * n_model != world_size:
        raise ValueError(
            f"mesh {n_data}x{n_model} does not cover {world_size} devices")
    return n_data, n_model


def group_ranks(n_data: int, n_model: int
                ) -> Tuple[List[List[int]], List[List[int]]]:
    """→ (the data groups' ranks, one list per model index; the model
    groups' ranks, one list per data index), the model axis innermost."""
    data = [[d * n_model + m for d in range(n_data)] for m in range(n_model)]
    model = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
    return data, model


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the ``(data, model)`` mesh and its two groups."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}


def create_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The ``(data, model)`` mesh over the initialised process group's
    ranks. Every rank must call it, in the same order as its other
    collectives: each group is created by all ranks."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: launch with torchrun and call "
            "maybe_initialize_distributed() first")
    rank = dist.get_rank()
    n_data, n_model = mesh_shape(cfg, dist.get_world_size())
    data_ranks, model_ranks = group_ranks(n_data, n_model)
    # every rank creates every group, in the same order
    data_groups = [dist.new_group(r) for r in data_ranks]
    model_groups = [dist.new_group(r) for r in model_ranks]
    d, m = divmod(rank, n_model)
    return Mesh(n_data, n_model, d, m, data_groups[m], model_groups[d])
