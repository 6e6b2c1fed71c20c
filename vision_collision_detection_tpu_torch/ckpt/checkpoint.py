"""Checkpoints with the reference's artifact roles and a true resume.

Counterpart of ``vision_collision_detection_tpu/ckpt/checkpoint.py``. One
checkpoint is a directory ``<run>/<role>/`` holding two files:

- ``vcd_meta.json``: JSON metadata, among it the ``hyperparams`` contract
  (the whole ``ExperimentConfig``) that inference rebuilds the
  architecture from; the same file name and contract as the JAX package's;
- ``arrays.pt``: a ``torch.save`` of the arrays, a dict of tensors, numbers,
  strings, lists and dicts. By convention ``model`` is the model's
  ``state_dict``; a trainer adds ``optimizer`` (the AdamW moments of
  ``train/optim.py``), ``step``, ``epoch``, the best metrics and the history.

Roles are ``best``, ``last`` and ``epoch_N``. A save writes ``<role>.tmp``
and renames it into place, so a reader never sees half a checkpoint. The
arrays load with ``weights_only=True``: nothing in a checkpoint is unpickled
as code.
"""

from __future__ import annotations

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
        """``arrays``: tensors and plain values (see the module docstring);
        ``meta``: JSON-serialisable, numpy scalars and arrays, tuples and
        sets allowed. Returns the checkpoint's directory."""
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
