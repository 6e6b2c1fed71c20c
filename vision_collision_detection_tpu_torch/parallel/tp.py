"""Tensor parallelism for the ViViT over the model group (Megatron-style),
with data parallelism over the data group.

Counterpart of ``vision_collision_detection_tpu/parallel/tp.py``. The JAX
package annotates the parameters' shardings and lets GSPMD insert the
collectives; here each rank holds its cut of the weights and the blocks
call the collectives themselves. The rules are the JAX package's
(``_rule_for``, ``tp.py:37-58``), on torch's ``Linear`` layout (weight
[out, in]):

- ``query``, ``key``, ``value``: column-parallel by heads (weight rows);
- ``out``: row-parallel by heads (weight columns), its bias added once
  after the partial products are summed;
- ``mlp_fc1``: column-parallel; ``mlp_fc2``: row-parallel;
- everything else replicated, and so is a layer whose heads (or hidden
  units) the model size does not divide: vivit_small's 6 heads over 4
  ranks stay whole.

A column-parallel layer's bias is cut with its output rows (the JAX rules
keep the bias whole and GSPMD slices it where it is added: the same sums).
Before each column-parallel pair stands ``_EnterModelGroup`` (identity
forward, the gradient summed over the model group in the backward), after
each row-parallel one ``_ExitModelGroup`` (the partial products summed in
the forward, identity backward). K4 runs on this rank's heads.

A checkpoint holds the full, gathered tensors (``full_state_dict``): it
loads into a single-device model, and a single-device checkpoint resumes a
tensor-parallel run (``shard_state_dict``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from vision_collision_detection_tpu_torch.models.vivit import TransformerBlock
from vision_collision_detection_tpu_torch.parallel.dp import (
    DataParallelStrategy,
)
from vision_collision_detection_tpu_torch.parallel.mesh import Mesh
from vision_collision_detection_tpu_torch.train.steps import TrainState


class _EnterModelGroup(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ExitModelGroup(torch.autograd.Function):
    """The sum over the model group; the backward is the identity."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.mark_dirty(y)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class ModelGroup:
    """The collectives a tensor-parallel block calls (its ``tp``)."""

    def __init__(self, group):
        self.group = group

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _EnterModelGroup.apply(x, self.group)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        return _ExitModelGroup.apply(y, self.group)


def rule_for(name: str, shape, n_model: int, num_heads: int) -> Optional[int]:
    """The dimension of a ``TransformerBlock`` parameter ``name`` (its
    state-dict name) cut over ``n_model`` ranks, None where it stays whole.
    ``num_heads``: the block's heads, which torch's [H·D, dim] weight does
    not show (flax's [dim, H, D] kernel does)."""
    *_, layer, kind = name.split(".")
    heads_ok = num_heads % n_model == 0
    if layer in ("query", "key", "value"):
        return 0 if heads_ok else None
    if layer == "out" and kind == "weight":
        return 1 if heads_ok else None
    if layer == "mlp_fc1":
        return 0 if shape[0] % n_model == 0 else None
    if layer == "mlp_fc2" and kind == "weight":
        return 1 if shape[1] % n_model == 0 else None
    return None


def shard_rules(model: nn.Module, n_model: int) -> Dict[str, int]:
    """{parameter name: the dimension cut} for every parameter of
    ``model`` that is cut over ``n_model`` ranks; the rest are
    replicated."""
    rules = {}
    for prefix, block in model.named_modules():
        if not isinstance(block, TransformerBlock):
            continue
        for name, p in block.named_parameters():
            dim = rule_for(name, p.shape, n_model, block.attn.num_heads)
            if dim is not None:
                rules[f"{prefix}.{name}" if prefix else name] = dim
    return rules


def shard_state_dict(sd: dict, rules: Dict[str, int], index: int,
                     n_model: int) -> dict:
    """A full state dict (``from_flax_params``, a checkpoint's ``model``)
    → the shards of model rank ``index``: each entry of ``rules`` cut in
    ``n_model`` equal parts along its dimension."""
    return {k: (v.chunk(n_model, rules[k])[index].clone() if k in rules
                else v) for k, v in sd.items()}


def _gather(t: torch.Tensor, dim: int, group, n_model: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(n_model)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def full_state_dict(sd: dict, rules: Dict[str, int], group,
                    n_model: int) -> dict:
    """The inverse of ``shard_state_dict``: each cut entry gathered over
    the model ``group`` (a collective: every rank of it calls this)."""
    return {k: (_gather(v, rules[k], group, n_model) if k in rules else v)
            for k, v in sd.items()}


def _optimizer_dims(optimizer: torch.optim.Optimizer,
                    dims: Dict[int, int]) -> List[Optional[int]]:
    """The cut dimension of each parameter in the optimizer's state-dict
    order (None: replicated); ``dims`` maps ``id(parameter)``."""
    return [dims.get(id(p)) for g in optimizer.param_groups
            for p in g["params"]]


def _walk_moments(sd: dict, dims: List[Optional[int]], fn) -> dict:
    """An optimizer state dict with ``fn(tensor, dim)`` applied to each
    per-parameter tensor of a cut parameter (AdamW's moments; not the step
    count, a 0-d tensor): the counterpart of ``shard_state``'s walk of the
    optax state (``tp.py:112-144``)."""
    state = {}
    for i, s in sd["state"].items():
        dim = dims[i]
        state[i] = {k: (fn(v, dim) if dim is not None and
                        isinstance(v, torch.Tensor) and v.dim() > 0 else v)
                    for k, v in s.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


class ModelParallelStrategy(DataParallelStrategy):
    """Trainer strategy: the batch sharded over the data group, the ViViT's
    attention and MLP weights cut over the model group.

    ``shard_state`` cuts the model in place and moves the optimizer onto
    the cuts (its moments with them); ``make_steps`` then reuses the
    single-device step bodies with the data group's collectives (DDP over
    the data group: a cut's gradient is summed only there, and a replicated
    weight's is already equal across the model group) and the global norm
    below."""

    def __init__(self, mesh: Mesh):
        super().__init__(mesh)
        self.rules: Dict[str, int] = {}
        self._dims: Dict[int, int] = {}

    def shard_state(self, model: nn.Module, state: TrainState) -> TrainState:
        """Cut ``model``'s parameters by the rules, in place (each cut block
        gets the model group's collectives), and move ``state``'s optimizer
        onto the cuts, any moments it holds cut as their parameters."""
        m = self.mesh
        self.rules = shard_rules(model, m.n_model)
        local = shard_state_dict(model.state_dict(), self.rules,
                                 m.model_index, m.n_model)
        moved = {}
        for name in self.rules:
            owner, attr = name.rsplit(".", 1)
            module = model.get_submodule(owner)
            old = getattr(module, attr)
            new = nn.Parameter(local[name], requires_grad=old.requires_grad)
            setattr(module, attr, new)
            moved[id(old)] = new
            self._dims[id(new)] = self.rules[name]
        group = ModelGroup(m.model_group)
        for prefix, block in model.named_modules():
            if isinstance(block, TransformerBlock):
                pre = f"{prefix}." if prefix else ""
                if pre + "attn.query.weight" in self.rules:
                    block.attn.tp = group
                if pre + "mlp_fc1.weight" in self.rules:
                    block.tp = group
        opt = state.optimizer
        full_sd = opt.state_dict()
        for g in opt.param_groups:
            g["params"] = [moved.get(id(p), p) for p in g["params"]]
        opt.state.clear()
        opt.load_state_dict(_walk_moments(
            full_sd, _optimizer_dims(opt, self._dims),
            lambda v, dim: v.chunk(m.n_model, dim)[m.model_index].clone()))
        return state

    def grad_norm(self, params: List[torch.nn.Parameter]) -> torch.Tensor:
        """A cut gradient's squares summed over the model group, a
        replicated one's counted once: the same norm on every rank, so
        model peers clip alike and their replicated weights stay equal."""
        dev = params[0].grad.device
        cut = torch.zeros((), device=dev)
        whole = torch.zeros((), device=dev)
        for p in params:
            sq = p.grad.float().square().sum()
            if id(p) in self._dims:
                cut += sq
            else:
                whole += sq
        dist.all_reduce(cut, group=self.mesh.model_group)
        return torch.sqrt(cut + whole)

    def full_state(self, model: nn.Module,
                   optimizer: torch.optim.Optimizer):
        m = self.mesh
        model_sd = full_state_dict(model.state_dict(), self.rules,
                                   m.model_group, m.n_model)
        opt_sd = _walk_moments(
            optimizer.state_dict(), _optimizer_dims(optimizer, self._dims),
            lambda v, dim: _gather(v, dim, m.model_group, m.n_model))
        return model_sd, opt_sd

    def load_full_state(self, model: nn.Module,
                        optimizer: torch.optim.Optimizer,
                        model_sd: dict, optimizer_sd: dict) -> None:
        m = self.mesh
        model.load_state_dict(shard_state_dict(
            model_sd, self.rules, m.model_index, m.n_model), strict=True)
        optimizer.load_state_dict(_walk_moments(
            optimizer_sd, _optimizer_dims(optimizer, self._dims),
            lambda v, dim: v.chunk(m.n_model, dim)[m.model_index].clone()))
