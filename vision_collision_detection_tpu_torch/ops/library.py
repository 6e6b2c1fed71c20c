"""K1–K4's serving launches as ``torch.library`` ops.

The kernels are ctypes launches on ``data_ptr()``, which ``torch.export``
cannot trace: it runs the model on fake tensors, which have no data. Each
forward launch a serving path makes is registered here as one op of the
``vcd`` namespace, so that an exported program holds it as one node:

- ``vcd::dequant_pad`` — K1, ``ops/dequant_pad.py`` ``_run``;
- ``vcd::dwconv7x7`` — K2's forward, ``ops/dwconv.py`` ``_forward``;
- ``vcd::convnext_mlp`` — K3's eval variant, ``ops/convnext_mlp.py``
  ``_eval``;
- ``vcd::flash_mha`` — K4's forward without the log-sum-exp,
  ``ops/flash_attention.py`` ``_forward`` (q, k, v may be strided views).

Each op's implementation, registered for CPU and CUDA tensors, dispatches
as its module does: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises, and the module's launch counters count
there. Each fake implementation only allocates the output, and is what a
``meta`` tensor gets. The public functions (``dequant_normalize_pad``,
``dwconv7x7``, ``convnext_mlp``, ``flash_mha``) call these ops wherever no
gradient is needed, in eager mode and while ``torch.export`` traces alike.
The training path's ``autograd.Function``s and the backward kernels are
not ops: a training step is not exported.

The ops are defined on a ``torch.library.Library`` rather than with
``torch.library.custom_op``, which wraps every call in
``torch._dynamo.disable``: its first call imports ``torch._dynamo`` and
sympy, seconds of a fresh serving process's first forward.

A program that holds these ops loads only where this module was imported
first (``infer/aot.py`` ``ServingBundle`` does); it imports the kernel
modules and nothing of the models.
"""

from __future__ import annotations

import torch

from vision_collision_detection_tpu_torch.ops import (
    convnext_mlp as _k3,
    dequant_pad as _k1,
    dwconv as _k2,
    flash_attention as _k4,
)

_LIB = torch.library.Library("vcd", "DEF")


def _define(schema: str, impl, fake):
    """Define ``vcd::<name>`` by ``schema``, with ``impl`` for CPU and CUDA
    tensors and ``fake`` for fake and meta tensors; return the op."""
    name = schema.split("(")[0]
    _LIB.define(schema)
    for key in ("CPU", "CUDA"):
        _LIB.impl(name, impl, key)
    torch.library.register_fake(f"vcd::{name}", fake, lib=_LIB)
    return getattr(torch.ops.vcd, name).default


def _dequant_pad_fake(frames_u8, target_size, mean, std, out_dtype):
    S = target_size
    return frames_u8.new_empty((*frames_u8.shape[:-3], S, S, 3),
                               dtype=out_dtype)


def _like_x(x, *rest):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _flash_mha_fake(q, k, v, sm_scale):
    return q.new_empty(q.shape)


# K1: uint8 [N, ch, cw, 3] → [N, S, S, 3] in ``out_dtype``.
dequant_pad = _define(
    "dequant_pad(Tensor frames_u8, int target_size, float[] mean, "
    "float[] std, ScalarType out_dtype) -> Tensor", _k1._run,
    _dequant_pad_fake)
# K2's forward: x [N, H, W, C], w [49, C], b [C] → [N, H, W, C].
dwconv7x7 = _define("dwconv7x7(Tensor x, Tensor w, Tensor b) -> Tensor",
                    _k2._forward, _like_x)
# K3's eval variant: [M, C] rows of x and y and the block's nine operands
# → [..., C] in x's dtype.
convnext_mlp = _define(
    "convnext_mlp(Tensor x, Tensor y, Tensor ln_w, Tensor ln_b, Tensor w1, "
    "Tensor b1, Tensor w2, Tensor b2, Tensor gamma, bool approximate) "
    "-> Tensor", _k3._eval, _like_x)
# K4's forward: q, k, v [B, S, H, D] → contiguous [B, S, H, D].
flash_mha = _define(
    "flash_mha(Tensor q, Tensor k, Tensor v, float sm_scale) -> Tensor",
    _k4._forward, _flash_mha_fake)
