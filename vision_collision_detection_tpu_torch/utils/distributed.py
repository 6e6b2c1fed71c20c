"""The one collective that layers below ``parallel/`` need: a barrier over
every rank. Imports nothing of the package, so the checkpoint store calls it
without importing the parallel strategies (which import the training
engine, which imports the store)."""

from __future__ import annotations

import torch
import torch.distributed as dist


def sync_global_devices(tag: str = "sync") -> None:
    """A barrier over every rank when there are several (``tag`` names it
    in the JAX package's API and has no effect here)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
