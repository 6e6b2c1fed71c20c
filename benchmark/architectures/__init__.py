"""One module per architecture: what the benchmark knows of a model.

A configuration file names its ``"architecture"``, and ``get`` imports
``benchmark/architectures/<architecture>.py``. Nothing else in the
harness names an architecture, so a new one enters as a new module beside
a configuration file, its metric files and its entries in
``BENCHMARK.json``. A module is plain PyTorch and imports nothing of the
program or of JAX. It defines:

- ``param_spec(c)``: (name, shape, law) of every parameter, in the order
  ``reference.weights.make_params`` draws them; the names and shapes are
  the program's state-dict keys;
- ``logits(P, frames, c, prec, training, generator, ckpt)``: the float32
  reference forward of model-ready frames (``reference.models.logits``
  rounds them as ``prec`` asks first): serving (no dropout) or training
  (the model's own frame fold, dropout drawn from ``generator``);
  ``ckpt`` recomputes each block in the backward;
- ``clip_flops(c, train)``: (FLOPs of one clip's forward, FLOPs of its
  first layer), products and convolutions only, two a multiply-add;
- ``frozen_mask(name, c)``: the part of parameter ``name`` that takes no
  gradient, or None;
- ``shrink(c)``: configuration ``c`` at a size a CPU test run holds, with
  the ``program`` overrides that make the program build that size;

and, where it needs them:

- ``COUNTERS``: launch counters of kernels the shared table
  (``harness.COUNTERS``) does not hold, in its form;
- ``LAWS``: parameter laws ``reference.weights.LAWS`` does not hold, in
  its form.

Launch lists of the kernels an architecture runs (``counts.Launch``) live
in its module; the metric files that read those kernels import them.
"""

from __future__ import annotations

import importlib


def get(name: str):
    """The module of architecture ``name``."""
    path = f"benchmark/architectures/{name}.py"
    if not name.isidentifier():
        raise ValueError(f"architecture {name!r} is not a module name ({path})")
    module = f"{__name__}.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ModuleNotFoundError(
            f"no module for architecture {name!r}: expected {path}",
            name=module) from None
