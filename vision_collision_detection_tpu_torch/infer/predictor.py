"""Serving forward: uint8 letterbox-content frames → class probabilities.

Counterpart of ``vision_collision_detection_tpu/infer/predictor.py``
(``CollisionPredictor``: ``_make_forward``, ``_fold_stride``,
``display_results``). The path is K1 (``eval_preprocess``) → ConvNeXt with
K2 and K3 in every block → bi-GRU → classifier MLP → softmax; or, for a
ViViT backbone, K1 → patch embedding → spatial blocks (K4 with
``attention_impl="flash"``) → temporal blocks → head → softmax.

``predict(paths)``, ``evaluate`` and the sliding-window forward wait for
the port of the C++ decoder (ROADMAP.md): this slice starts where the
decoder's output ends, a uint8 ``[B, T, ch, cw, 3]`` content batch.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Mapping, Optional

import torch

from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.models import build_model
from vision_collision_detection_tpu_torch.ops.preprocess import eval_preprocess
from vision_collision_detection_tpu_torch.utils.device import resolve_device


class CollisionPredictor:
    def __init__(self, cfg: ExperimentConfig,
                 state_dict: Optional[Mapping[str, torch.Tensor]],
                 device=None, dwconv_kernel=None, fused_mlp=None):
        """``state_dict``: the model's weights (``models.convert`` bridges a
        flax tree into one), or None to keep the seeded initial weights.
        ``device`` defaults to the card. ``dwconv_kernel``/``fused_mlp``
        override the ConvNeXt blocks' switches (None: the module default)."""
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg.model, device=self.device,
                                 dwconv_kernel=dwconv_kernel,
                                 fused_mlp=fused_mlp,
                                 frame_size=cfg.data.frame_size)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.class_names = tuple(cfg.data.class_names)
        self._forward_cache: Dict[bool, object] = {}

    def _make_forward(self, folded_stride: bool):
        """uint8 frames [B, T, ch, cw, 3] (tensor or array) → probs [B, C]
        float32 on the predictor's device. With ``folded_stride`` the
        decoder already kept every k-th frame (k = model.frame_subsample),
        so the model's own subsample is off; the parameters are shared."""
        key = bool(folded_stride)
        if key in self._forward_cache:
            return self._forward_cache[key]
        model = self.model
        if folded_stride:
            model = copy.copy(model)  # shares parameters and submodules
            model.frame_subsample = 1
        aug = self.cfg.augment
        S = self.cfg.data.frame_size
        dtype = getattr(torch, self.cfg.model.dtype)
        device = self.device

        @torch.inference_mode()
        def _forward(frames_u8):
            x = torch.as_tensor(frames_u8).to(device, non_blocking=True)
            x = eval_preprocess(x, aug, S, dtype)
            logits = model(x)
            return torch.softmax(logits.to(torch.float32), dim=-1)

        self._forward_cache[key] = _forward
        return _forward

    def _fold_stride(self) -> int:
        """The stride the decoder may keep frames at because the model
        would subsample them anyway. A ViViT never subsamples, so its
        stride is 1: the JAX predictor folds by ``frame_subsample`` for
        every backbone, which hands a ViViT half the frames its unfolded
        forward sees."""
        m = self.cfg.model
        T = self.cfg.data.num_frames
        if m.backbone.startswith("vivit"):
            return 1
        if m.frame_subsample > 1 and T > m.subsample_threshold:
            return m.frame_subsample
        return 1

    @staticmethod
    def display_results(results: List[Dict], width: int = 40) -> str:
        """ANSI bar chart per clip; returns the text."""
        lines = []
        for r in results:
            name = r.get("id") or os.path.basename(r.get("video_path", "?"))
            if not r.get("success", True):
                lines.append(f"{name}: ERROR ({r.get('error')})")
                continue
            lines.append(f"{name}: {r['predicted_class']} "
                         f"({r['confidence'] * 100:.1f}%)")
            for cls, p in r["probabilities"].items():
                bar = "█" * int(p * width)
                lines.append(f"  {cls:<15} {bar:<{width}} {p * 100:5.1f}%")
        text = "\n".join(lines)
        print(text)
        return text
