"""Checkpoints with the reference's artifact roles and a true resume.

Counterpart of ``vision_collision_detection_tpu/ckpt/checkpoint.py``. One
checkpoint is a directory ``<run>/<role>/`` holding two files:

- ``vcd_meta.json``: JSON metadata, among it the ``hyperparams`` contract
  (the whole ``ExperimentConfig``) that inference rebuilds the
  architecture from; the same file name and contract as the JAX package's;
- ``arrays.pt``: a ``torch.save`` of the arrays, a dict of tensors, numbers,
  strings, lists and dicts. By convention ``model`` is the model's
  ``state_dict``; a trainer adds ``optimizer`` (the AdamW moments of
  ``train/optim.py``) and ``step``. ``save`` turns a numpy array into a
  tensor and a numpy scalar into a Python number, and refuses any other
  leaf before it writes anything: every role it reports can be loaded.

Roles are ``best``, ``last`` and ``epoch_N``. A save writes ``<role>.tmp``
and renames it into place, so a reader never sees half a checkpoint. The
arrays load with ``weights_only=True``: nothing in a checkpoint is unpickled
as code.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

META_FILE = "vcd_meta.json"
ARRAYS_FILE = "arrays.pt"


class CheckpointStore:
    """Manages best/last/epoch_N checkpoints under a run directory."""

    def __init__(self, run_dir: str, keep_epochs: int = 3):
        self.run_dir = os.path.abspath(run_dir)
        self.keep_epochs = keep_epochs
        os.makedirs(self.run_dir, exist_ok=True)

    def path(self, role: str) -> str:
        return os.path.join(self.run_dir, role)

    def exists(self, role: str) -> bool:
        return os.path.isfile(os.path.join(self.path(role), ARRAYS_FILE))

    def save(self, role: str, *, arrays: dict, meta: dict) -> str:
        """``arrays``: tensors, numpy arrays and scalars, and plain values
        (see the module docstring); any other leaf raises ``TypeError``
        before anything is written. ``meta``: JSON-serialisable, numpy
        scalars and arrays, tuples and sets allowed. Returns the
        checkpoint's directory."""
        arrays = _loadable(arrays, "arrays")
        target = self.path(role)
        tmp = target + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(arrays, os.path.join(tmp, ARRAYS_FILE))
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f, indent=2, default=_json_default)
        if os.path.isdir(target):
            shutil.rmtree(target)
        os.replace(tmp, target)
        return target

    def load(self, role: str, map_location=None) -> tuple:
        return load_checkpoint(self.path(role), map_location)

    def save_epoch(self, epoch: int, **kw) -> str:
        path = self.save(f"epoch_{epoch}", **kw)
        self._prune_epochs()
        return path

    def _prune_epochs(self):
        epochs = []
        for name in os.listdir(self.run_dir):
            if name.startswith("epoch_") and not name.endswith(".tmp"):
                try:
                    epochs.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        for e in sorted(epochs)[: -self.keep_epochs] if self.keep_epochs else []:
            shutil.rmtree(os.path.join(self.run_dir, f"epoch_{e}"),
                          ignore_errors=True)

    def latest_role(self) -> Optional[str]:
        """best → last → newest epoch, the reference's test-time fallback."""
        for role in ("best", "last"):
            if self.exists(role):
                return role
        epochs = []
        for n in os.listdir(self.run_dir):
            if n.startswith("epoch_") and self.exists(n):
                try:
                    epochs.append(int(n.split("_")[1]))
                except ValueError:
                    continue
        return f"epoch_{max(epochs)}" if epochs else None


def load_checkpoint(path: str, map_location=None) -> tuple:
    """→ (arrays, meta dict). ``path`` is a checkpoint directory;
    ``map_location`` places the tensors (default: where they were saved)."""
    arrays = torch.load(os.path.join(path, ARRAYS_FILE),
                        map_location=map_location, weights_only=True)
    meta_path = os.path.join(path, META_FILE)
    meta: dict = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return arrays, meta


_PLAIN = (bool, int, float, complex, str, bytes, type(None))


def _loadable(obj: Any, where: str) -> Any:
    """``obj`` with numpy arrays as tensors and numpy scalars as Python
    numbers, so that ``torch.load(..., weights_only=True)`` reads it back;
    a leaf it would refuse raises ``TypeError`` naming its path."""
    if isinstance(obj, np.generic):  # before the plain types: np.float64
        return obj.item()               # is a float
    if isinstance(obj, (torch.Tensor, torch.Size, torch.dtype)) or \
            type(obj) in _PLAIN:
        return obj
    if isinstance(obj, np.ndarray):
        if obj.dtype == object:
            raise TypeError(f"{where}: a numpy array of Python objects "
                            "cannot be loaded with weights_only=True")
        return torch.from_numpy(np.array(obj, order="C"))  # 0-d stays 0-d
    if type(obj) in (dict, collections.OrderedDict):
        out = type(obj)((_loadable(k, f"{where} key"),
                         _loadable(v, f"{where}[{k!r}]"))
                        for k, v in obj.items())
        if hasattr(obj, "_metadata"):  # a state_dict's module versions
            out._metadata = obj._metadata
        return out
    if type(obj) in (list, tuple):
        return type(obj)(_loadable(v, f"{where}[{i}]")
                         for i, v in enumerate(obj))
    raise TypeError(f"{where}: a {type(obj).__name__} cannot be loaded with "
                    "weights_only=True; save tensors, numpy values, numbers, "
                    "strings, lists and dicts")


def _json_default(o: Any):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (set, tuple)):
        return list(o)
    raise TypeError(f"not JSON serializable: {type(o)}")
