"""Data parallelism: one process per device, the batch sharded over the data
group, the gradients summed by ``DistributedDataParallel``.

Counterpart of ``vision_collision_detection_tpu/parallel/dp.py``, with its
semantics:

- **Loss.** Each rank's loss is Σ_local perᵢ·wᵢ / Σ_global wᵢ, the weights
  summed over the data group, so the ranks' losses sum to the loss of one
  device on the concatenated batch, and the **sum** of their gradients is
  its gradient (``dp.py:105-149``). DDP averages by default; here a
  communication hook sums each gradient bucket over the data group
  (``_sum_hook``). The reported loss, accuracy and gradient norm are the
  global ones; clipping uses that norm.
- **BatchNorm.** Every rank normalises with its own batch's statistics
  (``models/norm.py`` as it is, not a SyncBN); after the optimizer's step
  each running mean and variance is replaced by its mean over the data
  group (the JAX ``pmean`` of ``batch_stats``, ``dp.py:150-152``). DDP is
  built with ``broadcast_buffers=False``, or it would overwrite the
  buffers with rank 0's at every forward.
- **Randomness.** The caller seeds each step's generator by the rank's data
  index (``train.trainer.step_seed``), as the JAX step folds the shard
  index into its key; ranks of one data index (tensor parallelism) draw
  the same flips, augmentation and dropout masks.
- **Evaluation.** Each rank evaluates its shard with the global weighted
  loss; ``gather_eval`` concatenates the ranks' arrays in data-index
  order (equal shapes by the loaders' ``pad_partial`` and ``mask_wrap``).

A collective's tensors go where its backend takes them: the card for NCCL,
the CPU for gloo (which also moves the CUDA tensors of a step).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from vision_collision_detection_tpu_torch.models.norm import BatchNorm
from vision_collision_detection_tpu_torch.parallel.mesh import (
    Mesh,
    collective_device,
    create_mesh,
)
from vision_collision_detection_tpu_torch.train.steps import (
    SingleDeviceStrategy,
)

# a tensor's (or array's) value as a host numpy array
to_host_numpy = SingleDeviceStrategy.to_host


def _sum_hook(group, bucket):
    """DDP communication hook: the bucket's gradients summed over the data
    group (DDP's own hook divides them by the group's size)."""
    work = dist.all_reduce(bucket.buffer(), group=group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


class DataParallelStrategy(SingleDeviceStrategy):
    """Inject into ``Trainer`` for training over several processes, one a
    device (each process drives one device, as ``SingleDeviceStrategy``;
    checkpoints hold the replicated weights as they are). ``mesh``:
    ``create_mesh()`` by default (every rank on the data axis). The
    inherited ``make_steps`` builds the single-device step bodies around
    this strategy's collectives (``wrap``, ``data_sum``, ``after_update``;
    ``grad_norm`` is the inherited one, taken on the summed gradients,
    which are the same on every rank)."""

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh or create_mesh()
        self.num_data_shards = self.mesh.n_data
        self.data_shard_index = self.mesh.data_index
        # --batch-size is per device, as in the JAX package: the global
        # batch is batch_size × n_data
        self.pad_batches = True

    @property
    def is_main(self) -> bool:
        return dist.get_rank() == 0

    # ---- the steps' collectives ------------------------------------------
    def wrap(self, model: torch.nn.Module) -> torch.nn.Module:
        dev = next(model.parameters()).device
        ddp = DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            process_group=self.mesh.data_group, broadcast_buffers=False)
        ddp.register_comm_hook(self.mesh.data_group, _sum_hook)
        return ddp

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, group=self.mesh.data_group)
        return t

    def after_update(self, model: torch.nn.Module) -> None:
        """Each BatchNorm's running statistics replaced by their mean over
        the data group, in one all-reduce."""
        stats = [b for m in model.modules() if isinstance(m, BatchNorm)
                 for b in (m.running_mean, m.running_var)]
        if not stats:
            return
        flat = torch.cat([b.reshape(-1) for b in stats])
        dist.all_reduce(flat, group=self.mesh.data_group)
        flat /= self.mesh.n_data
        for b, v in zip(stats, flat.split([b.numel() for b in stats])):
            b.copy_(v.view_as(b))

    # ---- evaluation ------------------------------------------------------
    def gather_eval(self, arrays: Dict[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
        """The data group's arrays concatenated in data-index order on
        every rank. Each array has the same shape on every rank (the
        loaders pad every shard to as many batches of as many rows)."""
        group = self.mesh.data_group
        dev = collective_device(group)
        out = {}
        for k, v in arrays.items():
            v = np.ascontiguousarray(v)
            # bool as uint8: not every backend reduces bool tensors
            t = torch.from_numpy(v.view(np.uint8) if v.dtype == bool
                                 else v).to(dev)
            parts = [torch.empty_like(t) for _ in range(self.mesh.n_data)]
            dist.all_gather(parts, t, group=group)
            g = torch.cat(parts).cpu().numpy()
            out[k] = g.view(bool) if v.dtype == bool else g
        return out
