"""Weights carried across from the JAX package.

``load_npz`` reads the flattened ``.npz`` tree that the JAX package's
``models/convert.py`` ``save_npz`` writes (keys are ``/``-joined paths), so
the port needs neither JAX nor orbax to read it. ``from_flax_params`` maps a
flax parameter tree of ``VideoClassifierModel`` or ``ViViT`` onto this
package's ``state_dict``:

=====================================  =====================================
flax                                   torch
=====================================  =====================================
conv kernel [kh, kw, in, out]          weight [out, in, kh, kw]
depthwise kernel [7, 7, 1, C]          [49, C] (K2 path) or [C, 1, 7, 7]
Dense kernel [in, out] (``fc1``,        Linear weight [out, in]
``sensor_fc1``, ``sensor_fc2``, ...)
LayerNorm scale / bias                 weight / bias
GRU ir/iz/in kernels and biases        weight_ih_l0{,_reverse} / bias_ih (r, z, n)
GRU hr/hz/hn kernels                   weight_hh_l0{,_reverse}
GRU hn bias                            bias_hh = [0, 0, b_hn]
attention query/key/value kernel       Linear weight [H·D, dim], bias [H·D]
[dim, H, D], bias [H, D]
attention out kernel [H, D, dim]       Linear weight [dim, H·D]
spatial_pos / temporal_pos             the same name, unchanged
=====================================  =====================================

The forward GRU direction comes from ``fw_cell``, the reverse from
``bw_cell``. A leaf the mapping does not know raises; ``load_flax_params``
loads with ``strict=True``, so a missing or extra key raises too.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_GRU_GATES = ("ir", "iz", "in", "hr", "hz", "hn")


def load_npz(path: str) -> Dict:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)


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


def _gru_direction(cell: Mapping, suffix: str) -> Dict[str, torch.Tensor]:
    if set(cell) != set(_GRU_GATES):
        raise KeyError(f"GRU cell has gates {sorted(cell)}, expected "
                       f"{sorted(_GRU_GATES)}")
    expected = {"ir": {"kernel", "bias"}, "iz": {"kernel", "bias"},
                "in": {"kernel", "bias"}, "hr": {"kernel"},
                "hz": {"kernel"}, "hn": {"kernel", "bias"}}
    for gate, keys in expected.items():
        if set(cell[gate]) != keys:
            raise KeyError(f"GRU gate {gate!r} has {sorted(cell[gate])}, "
                           f"expected {sorted(keys)}")
    w_ih = torch.cat([_t(cell[g]["kernel"]).t() for g in ("ir", "iz", "in")])
    b_ih = torch.cat([_t(cell[g]["bias"]) for g in ("ir", "iz", "in")])
    w_hh = torch.cat([_t(cell[g]["kernel"]).t() for g in ("hr", "hz", "hn")])
    b_hn = _t(cell["hn"]["bias"])
    b_hh = torch.cat([torch.zeros_like(b_hn), torch.zeros_like(b_hn), b_hn])
    return {f"weight_ih_l0{suffix}": w_ih, f"bias_ih_l0{suffix}": b_ih,
            f"weight_hh_l0{suffix}": w_hh, f"bias_hh_l0{suffix}": b_hh}


def _convert(node: Mapping, prefix: str, dwconv_kernel: bool,
             out: Dict[str, torch.Tensor]) -> None:
    for name, child in node.items():
        path = f"{prefix}{name}"
        if not isinstance(child, Mapping):
            if name in ("gamma", "spatial_pos", "temporal_pos"):
                out[path] = _t(child)
                continue
            raise KeyError(f"unexpected parameter leaf {path!r}")
        if "fw_cell" in child or "bw_cell" in child:
            # a recurrent head: its cells become one nn.GRU named `gru`
            rest = {k: v for k, v in child.items()
                    if k not in ("fw_cell", "bw_cell")}
            out.update({f"{path}.gru.{k}": v for k, v in
                        _gru_direction(child["fw_cell"], "").items()})
            if "bw_cell" in child:
                out.update({f"{path}.gru.{k}": v for k, v in
                            _gru_direction(child["bw_cell"], "_reverse").items()})
            _convert(rest, f"{path}.", dwconv_kernel, out)
            continue
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
            else:
                raise KeyError(f"unexpected kernel rank {k.dim()} at {path!r}")
            out[f"{path}.weight"] = w
            if "bias" in child:
                out[f"{path}.bias"] = _t(child["bias"]).reshape(-1)
            continue
        if "scale" in child:
            if set(child) != {"scale", "bias"}:
                raise KeyError(f"unexpected LayerNorm leaves at {path!r}: "
                               f"{sorted(child)}")
            out[f"{path}.weight"] = _t(child["scale"])
            out[f"{path}.bias"] = _t(child["bias"])
            continue
        _convert(child, f"{path}.", dwconv_kernel, out)


def from_flax_params(tree: Mapping, *, dwconv_kernel: bool = True
                     ) -> Dict[str, torch.Tensor]:
    """flax params (nested dict of arrays; a ``{"params": ...}`` variables
    tree is unwrapped) → float32 ``state_dict`` of ``VideoClassifierModel``
    or ``ViViT``.
    ``dwconv_kernel`` must match the model's blocks: it picks the depthwise
    weight layout."""
    if "params" in tree:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    _convert(tree, "", dwconv_kernel, out)
    return out


def load_flax_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Load a flax parameter tree into ``model``; a missing or extra key
    raises."""
    blocks = [m for m in model.modules() if hasattr(m, "use_dwconv_kernel")]
    kinds = {m.use_dwconv_kernel for m in blocks}
    if len(kinds) > 1:
        raise ValueError("model mixes depthwise-conv layouts across blocks")
    sd = from_flax_params(tree, dwconv_kernel=kinds.pop() if kinds else True)
    model.load_state_dict(sd, strict=True)
