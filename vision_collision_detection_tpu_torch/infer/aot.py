"""Exported serving bundles: trace once, serve from the artifact.

Counterpart of ``vision_collision_detection_tpu/infer/aot.py``. The
uint8 → probabilities program that ``CollisionPredictor`` serves
(``ServingForward``: K1 → model → softmax) is captured with
``torch.export`` once, with a dynamic batch dimension and the weights
embedded, and saved with ``torch.export.save``. A serving host reloads it with
``ServingBundle``: no model code, no checkpoint restore, no re-tracing —
``torch``, this module and the kernels' op registrations
(``ops/library.py``), which ``torch.export.load`` needs to resolve the
``vcd::`` nodes.

Bundle layout (a directory)::

    manifest.json      # format version, shapes, buckets, platforms,
                       # class names, hyperparams provenance
    fwd.pt2            # the exported program, batch 1 to the largest bucket

Batching: a request is zero-padded up to the smallest bucket that holds it
and sliced back; a larger one is chunked through the largest bucket, so any
request size is served at a fixed set of batch shapes. The JAX package
lowers one program per bucket; here one program serves every bucket, so
the weights are read from disk and held on the device once.

An exported graph carries no cuDNN flags: the float32 pins of the models
(``utils/precision.py``) leave no trace in it, so ``ServingBundle`` runs
every call inside ``Float32Pin`` to keep the float32 GRU and convolutions
out of TF32.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vision_collision_detection_tpu_torch.utils.device import resolve_device
from vision_collision_detection_tpu_torch.utils.precision import Float32Pin

FORMAT_VERSION = 1
MANIFEST = "manifest.json"
PROGRAM = "fwd.pt2"


def _forward_shape(cfg, content_box: Optional[Tuple[int, int]]):
    """([T, H, W, 3] uint8 input shape of the serving forward, folded
    stride): the predictor's frame count after its fold (``fold_stride``,
    1 for a ViViT) over the full letterbox canvas, or the content rows only
    when a content box is pinned."""
    from vision_collision_detection_tpu_torch.infer.predictor import (
        fold_stride,
    )

    d = cfg.data
    stride = fold_stride(cfg)
    T = -(-d.num_frames // stride)
    h, w = content_box if content_box else (d.frame_size, d.frame_size)
    return (T, int(h), int(w), 3), stride


def export_bundle(
    predictor,
    out_dir: str,
    batch_sizes: Sequence[int] = (1, 8, 32),
    content_box: Optional[Tuple[int, int]] = None,
    platforms: Optional[Sequence[str]] = None,
) -> dict:
    """Export ``predictor``'s serving forward into ``out_dir``: one program
    whose batch dimension runs from 1 to the largest of ``batch_sizes``,
    the buckets a request is padded to.

    platforms: the device types the bundle is for; default and only choice
    the predictor's own (``["cuda"]`` or ``["cpu"]``). Another raises
    ``ValueError``: ``torch.export`` traces the program on the predictor's
    device, so a CPU host cannot export a bundle for the card the way the
    JAX package lowers for a TPU from a CPU. The export runs without
    gradients, so every kernel is its eval launch."""
    platform = predictor.device.type
    if platforms and list(platforms) != [platform]:
        raise ValueError(f"a bundle is exported for the predictor's device "
                         f"type [{platform!r}], not {list(platforms)}")
    (T, H, W, C), stride = _forward_shape(predictor.cfg, content_box)
    module = predictor.serving_module(stride > 1)
    buckets = sorted(set(int(b) for b in batch_sizes))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")

    # a traced batch of 1 would be specialised to 1: trace at 2 or more
    top = max(2, buckets[-1])
    batch = torch.export.Dim("batch", min=1, max=top)
    example = torch.zeros((top, T, H, W, C), dtype=torch.uint8,
                          device=predictor.device)
    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        exported = torch.export.export(module, (example,),
                                       dynamic_shapes=({0: batch},),
                                       strict=False)
    exported.example_inputs = None  # else the zeros are saved too
    torch.export.save(exported, os.path.join(out_dir, PROGRAM))

    manifest = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "platforms": [platform],
        "buckets": buckets,
        "frame_shape": [T, H, W, C],
        "folded_stride": stride,
        "input_dtype": "uint8",
        "class_names": list(predictor.class_names),
        "hyperparams": predictor.cfg.to_dict(),
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


class ServingBundle:
    """Load an exported bundle and serve uint8 clips → class probabilities.

    Needs ``torch``, ``numpy`` and the kernels' op registrations at
    runtime; the parameters are inside the program. ``device`` defaults
    to the card (no card raises); a bundle exported for another device
    type is refused."""

    def __init__(self, path: str, device=None):
        self.device = resolve_device(device)
        with open(os.path.join(path, MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"bundle format {self.manifest['format_version']} is newer "
                f"than this runtime ({FORMAT_VERSION})")
        if self.device.type not in self.manifest["platforms"]:
            raise ValueError(
                f"bundle was exported for {self.manifest['platforms']}, "
                f"this runtime serves on {self.device.type!r}")
        # the vcd:: nodes resolve to these registrations
        from vision_collision_detection_tpu_torch.ops import library  # noqa: F401

        self.class_names = tuple(self.manifest["class_names"])
        self.frame_shape = tuple(self.manifest["frame_shape"])
        self.buckets: List[int] = sorted(self.manifest["buckets"])
        self._program = torch.export.load(os.path.join(path, PROGRAM)).module()

    def run(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """One program call on a [B, T, H, W, 3] uint8 tensor on the device
        (B a bucket) → probabilities [B, C] on the device, with cuDNN's
        float32 math pinned."""
        with torch.inference_mode(), Float32Pin():
            return self._program(frames_u8)

    def predict_probs(self, frames_u8) -> np.ndarray:
        """[B, T, H, W, 3] uint8 (array or tensor) → [B, num_classes]
        float32 probabilities."""
        frames_u8 = torch.as_tensor(frames_u8)
        if tuple(frames_u8.shape[1:]) != self.frame_shape:
            raise ValueError(
                f"expected per-clip shape {self.frame_shape}, "
                f"got {tuple(frames_u8.shape[1:])}")
        n = frames_u8.shape[0]
        out = []
        i = 0
        while i < n:
            remaining = n - i
            bucket = next((b for b in self.buckets if b >= remaining),
                          self.buckets[-1])
            take = min(remaining, bucket)
            chunk = torch.zeros((bucket,) + self.frame_shape,
                                dtype=torch.uint8, device=self.device)
            chunk[:take].copy_(frames_u8[i:i + take])
            out.append(self.run(chunk)[:take].cpu().numpy())
            i += take
        return np.concatenate(out) if out else np.zeros(
            (0, len(self.class_names)), np.float32)

    def predict(self, frames_u8) -> List[Dict]:
        """Result dicts in the ``CollisionPredictor.predict`` schema for
        decoded clips (decode stays the caller's: the bundle is the device
        half of the pipeline)."""
        probs = self.predict_probs(frames_u8)
        results = []
        for p in probs:
            k = int(p.argmax())
            results.append({
                "success": True,
                "predicted_class": self.class_names[k],
                "predicted_label": k,
                "confidence": float(p[k]),
                "probabilities": {
                    name: float(p[j])
                    for j, name in enumerate(self.class_names)
                },
            })
        return results
