"""Weights carried across from the JAX package.

``load_npz`` reads the flattened ``.npz`` tree that the JAX package's
``models/convert.py`` ``save_npz`` writes (keys are ``/``-joined paths), so
the port needs neither JAX nor orbax to read it; ``save_npz`` writes the
same file, and ``convert_checkpoint_file`` turns a torchvision ``.pth``
into one (``cli/convert_weights.py``). ``from_flax_params`` maps a
flax variables tree (``params`` and, for the BatchNorm models,
``batch_stats``) of ``VideoClassifierModel``, ``ViViT`` or
``ReferenceVideoClassifier`` onto this package's ``state_dict``; the port's
modules keep the JAX modules' names, so the map goes name to name:

=====================================  =====================================
flax                                   torch
=====================================  =====================================
conv kernel [kh, kw, in, out]          weight [out, in, kh, kw]
depthwise kernel [7, 7, 1, C]          [49, C] (K2 path) or [C, 1, 7, 7]
conv over T kernel [k, in, out]        Conv1d weight [out, in, k]
Dense kernel [in, out] (``fc1``,        Linear weight [out, in]
``sensor_fc1``, ``query``, ...)
LayerNorm / BatchNorm scale, bias      weight / bias
BatchNorm batch_stats mean, var        running_mean / running_var
GRU ir/iz/in kernels and biases        weight_ih / bias_ih (r, z, n)
GRU hr/hz/hn kernels                   weight_hh
GRU hn bias                            bias_hh = [0, 0, b_hn]
LSTM ii/if/ig/io kernels               weight_ih (i, f, g, o); bias_ih = 0
LSTM hi/hf/hg/ho kernels and biases    weight_hh / bias_hh
SimpleCell i kernel and bias           weight_ih / bias_ih
SimpleCell h kernel                    weight_hh; bias_hh = 0
attention query/key/value kernel       Linear weight [H·D, dim], bias [H·D]
[dim, H, D], bias [H, D]
attention out kernel [H, D, dim]       Linear weight [dim, H·D]
spatial_pos / temporal_pos /           the same name, unchanged
pos_embedding
=====================================  =====================================

A recurrent head's cells ``fw_cell``/``bw_cell`` become one torch module
named after the cell (``gru``, ``lstm``, ``rnn``), the forward direction
``_l0`` and the reverse ``_l0_reverse``; a reference head's stacked cells
``l{n}_fw_cell``/``l{n}_bw_cell`` become one multi-layer module ``rnn``
(``_l{n}``, ``_l{n}_reverse``), as the reference names it. A leaf the
mapping does not know raises; ``load_flax_params`` loads with
``strict=True``, so a missing or extra key raises too.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

# the flax cell's gates → (torch module name, gates in torch's order)
_CELLS = {
    frozenset(("ir", "iz", "in", "hr", "hz", "hn")): "gru",
    frozenset(("ii", "if", "ig", "io", "hi", "hf", "hg", "ho")): "lstm",
    frozenset(("i", "h")): "rnn",
}
_CELL_NAME = re.compile(r"^(?:l(\d+)_)?(fw|bw)_cell$")


def save_npz(tree: Mapping, path: str) -> None:
    """Write a nested tree of arrays as the flat ``.npz`` (``/``-joined
    keys) that the JAX package's ``save_npz`` writes and ``load_npz``
    reads."""
    np.savez(path, **_flatten(tree))


def load_npz(path: str) -> Dict:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _leaves(gate: Mapping, keys, where: str):
    if set(gate) != set(keys):
        raise KeyError(f"{where} has {sorted(gate)}, expected {sorted(keys)}")


def _cell(cell: Mapping, path: str):
    """One direction of one layer: flax cell → (torch module name,
    {weight_ih, weight_hh, bias_ih, bias_hh})."""
    kind = _CELLS.get(frozenset(cell))
    if kind is None:
        raise KeyError(f"recurrent cell {path!r} has gates {sorted(cell)}")

    def kernels(names):
        return torch.cat([_t(cell[g]["kernel"]).t() for g in names])

    def biases(names):
        return torch.cat([_t(cell[g]["bias"]) for g in names])

    if kind == "gru":
        for g in ("ir", "iz", "in", "hn"):
            _leaves(cell[g], ("kernel", "bias"), f"{path}.{g}")
        for g in ("hr", "hz"):
            _leaves(cell[g], ("kernel",), f"{path}.{g}")
        b_hn = _t(cell["hn"]["bias"])
        b_hh = torch.cat([torch.zeros(2 * b_hn.shape[0]), b_hn])
        return kind, {"weight_ih": kernels(("ir", "iz", "in")),
                      "weight_hh": kernels(("hr", "hz", "hn")),
                      "bias_ih": biases(("ir", "iz", "in")),
                      "bias_hh": b_hh}
    if kind == "lstm":
        for g in "ifgo":
            _leaves(cell["i" + g], ("kernel",), f"{path}.i{g}")
            _leaves(cell["h" + g], ("kernel", "bias"), f"{path}.h{g}")
        b_hh = biases(("hi", "hf", "hg", "ho"))
        return kind, {"weight_ih": kernels(("ii", "if", "ig", "io")),
                      "weight_hh": kernels(("hi", "hf", "hg", "ho")),
                      "bias_ih": torch.zeros_like(b_hh), "bias_hh": b_hh}
    _leaves(cell["i"], ("kernel", "bias"), f"{path}.i")
    _leaves(cell["h"], ("kernel",), f"{path}.h")
    b_ih = _t(cell["i"]["bias"])
    return kind, {"weight_ih": kernels(("i",)), "weight_hh": kernels(("h",)),
                  "bias_ih": b_ih, "bias_hh": torch.zeros_like(b_ih)}


def _recurrence(cells: Mapping, path: str, out: Dict[str, torch.Tensor]):
    """A head's cells (``fw_cell``/``bw_cell`` or ``l{n}_fw_cell``/...) →
    the keys of one torch RNN module under ``path``."""
    for name, cell in cells.items():
        layer, direction = _CELL_NAME.match(name).groups()
        kind, tensors = _cell(cell, f"{path}{name}")
        module = kind if layer is None else "rnn"
        suffix = f"_l{layer or 0}" + ("_reverse" if direction == "bw" else "")
        out.update({f"{path}{module}.{k}{suffix}": v
                    for k, v in tensors.items()})


def _convert(node: Mapping, prefix: str, dwconv_kernel: bool,
             out: Dict[str, torch.Tensor]) -> None:
    cells = {k: v for k, v in node.items() if _CELL_NAME.match(k)}
    if cells:  # a recurrent head: its cells become one torch RNN module
        _recurrence(cells, prefix, out)
        node = {k: v for k, v in node.items() if k not in cells}
    for name, child in node.items():
        path = f"{prefix}{name}"
        if not isinstance(child, Mapping):
            if name in ("gamma", "spatial_pos", "temporal_pos",
                        "pos_embedding"):
                out[path] = _t(child)
                continue
            raise KeyError(f"unexpected parameter leaf {path!r}")
        if "kernel" in child:
            k = _t(child["kernel"])
            if set(child) - {"kernel", "bias"}:
                raise KeyError(f"unexpected leaves under {path!r}: "
                               f"{sorted(set(child) - {'kernel', 'bias'})}")
            if k.dim() == 4 and name == "dwconv" and k.shape[2] == 1:
                kh, kw, _, c = k.shape
                w = (k.reshape(kh * kw, c) if dwconv_kernel
                     else k.permute(3, 2, 0, 1).contiguous())
            elif k.dim() == 4:
                w = k.permute(3, 2, 0, 1).contiguous()
            elif k.dim() == 2:
                w = k.t().contiguous()
            elif k.dim() == 3 and name in ("query", "key", "value"):
                # DenseGeneral over heads: [dim, H, D], bias [H, D]
                w = k.reshape(k.shape[0], -1).t().contiguous()
            elif k.dim() == 3 and name == "out":
                # DenseGeneral back from heads: [H, D, dim]
                w = k.reshape(-1, k.shape[-1]).t().contiguous()
            elif k.dim() == 3:
                # a convolution over T: [k, in, out] → Conv1d [out, in, k]
                w = k.permute(2, 1, 0).contiguous()
            else:
                raise KeyError(f"unexpected kernel rank {k.dim()} at {path!r}")
            out[f"{path}.weight"] = w
            if "bias" in child:
                out[f"{path}.bias"] = _t(child["bias"]).reshape(-1)
            continue
        if "scale" in child:
            if set(child) != {"scale", "bias"}:
                raise KeyError(f"unexpected norm leaves at {path!r}: "
                               f"{sorted(child)}")
            out[f"{path}.weight"] = _t(child["scale"])
            out[f"{path}.bias"] = _t(child["bias"])
            continue
        _convert(child, f"{path}.", dwconv_kernel, out)


def _convert_stats(node: Mapping, prefix: str,
                   out: Dict[str, torch.Tensor]) -> None:
    """flax ``batch_stats`` (``{mean, var}`` under each BatchNorm's path)
    → ``running_mean``/``running_var``."""
    for name, child in node.items():
        path = f"{prefix}{name}"
        if not isinstance(child, Mapping):
            raise KeyError(f"unexpected batch_stats leaf {path!r}")
        if "mean" in child or "var" in child:
            _leaves(child, ("mean", "var"), f"batch_stats {path!r}")
            out[f"{path}.running_mean"] = _t(child["mean"])
            out[f"{path}.running_var"] = _t(child["var"])
            continue
        _convert_stats(child, f"{path}.", out)


def from_flax_params(tree: Mapping, *, dwconv_kernel: bool = True
                     ) -> Dict[str, torch.Tensor]:
    """flax params, or a variables tree ``{"params": ..., "batch_stats":
    ...}`` → float32 ``state_dict``. ``dwconv_kernel`` must match the
    model's ConvNeXt blocks: it picks the depthwise weight layout."""
    stats = {}
    if "params" in tree:
        stats = tree.get("batch_stats") or {}
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    _convert(tree, "", dwconv_kernel, out)
    _convert_stats(stats, "", out)
    return out


def load_flax_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Load a flax parameter or variables tree into ``model``; a missing or
    extra key raises."""
    blocks = [m for m in model.modules() if hasattr(m, "use_dwconv_kernel")]
    kinds = {m.use_dwconv_kernel for m in blocks}
    if len(kinds) > 1:
        raise ValueError("model mixes depthwise-conv layouts across blocks")
    sd = from_flax_params(tree, dwconv_kernel=kinds.pop() if kinds else True)
    model.load_state_dict(sd, strict=True)


def convert_checkpoint_file(pth_path: str, backbone: str,
                            out_path: str) -> str:
    """A torchvision ImageNet ``state_dict`` (``.pth``) → the backbone's
    flax-layout ``.npz`` (checked against the manifest first), which
    ``load_pretrained_backbone`` reads; returns ``out_path``."""
    from vision_collision_detection_tpu_torch.models.import_torch import (
        convert_torch_state_dict,
    )

    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    save_npz(convert_torch_state_dict(sd, backbone, validate=True), out_path)
    return out_path
