"""The reference's ``EnhancedFrameCNN``, for imported reference checkpoints.

Counterpart of ``vision_collision_detection_tpu/models/reference_model.py``:
a frame backbone (the ConvNeXt without its head LayerNorm, as the
reference's ``classifier = Identity`` leaves it), one of the reference's
temporal heads (``models/reference_heads.py``), and the reference's
classifier Linear(D, 512) + BatchNorm + ReLU + Dropout → Linear(512, 256) +
BatchNorm + ReLU + Dropout → Linear(256, num_classes). Frames are
subsampled every 2nd when T > 10, as the reference does.

float32 by default, the reference's precision; ``dtype=torch.bfloat16`` is
the faster option. The ConvNeXt blocks take the module defaults
(``models/backbones/convnext.py``): in float32 K2 on the float32 route of
``dwconv_hopper.cu`` (float32 sums) and the stock float32 MLP chain, as
the JAX package computes it (``fused_mlp=True`` sends them to K3's float32
routes, ``convnext_mlp_wgmma.cu`` up to C = 768 and ``convnext_mlp_wide.cu``
at 1024 and 1536, whose products round to bf16 by K3's rule); in bf16 K2
and K3 on the same Hopper kernels.

The ConvNeXt pads as torchvision's does (``padding="VALID"``: the stem and
downsample convolutions drop the remainder of an odd side), so a
checkpoint serves the reference's numbers at any frame side. Here the
port departs from the JAX package, whose reference model pads flax's
``SAME`` (the same at 224² and 96²; at 112² its last downsample sees 7
rows and gives 4 where torchvision gives 3).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vision_collision_detection_tpu_torch.models.backbones import (
    build_backbone,
    feature_dim,
)
from vision_collision_detection_tpu_torch.models.backbones.convnext import (
    linear,
)
from vision_collision_detection_tpu_torch.models.norm import BatchNorm
from vision_collision_detection_tpu_torch.models.reference_heads import (
    TORCH_EPS,
    build_reference_head,
)
from vision_collision_detection_tpu_torch.models.temporal import dropout
from vision_collision_detection_tpu_torch.models.video_classifier import (
    canonicalize_video_layout,
    init_weights,
)
from vision_collision_detection_tpu_torch.utils.device import resolve_device


class ReferenceVideoClassifier(nn.Module):
    def __init__(self, backbone: str = "convnext_tiny",
                 temporal_mode: str = "gru", num_classes: int = 3,
                 attention_heads: int = 4, temporal_kernel_size: int = 3,
                 rnn_hidden_dim: int = 512, rnn_num_layers: int = 2,
                 rnn_bidirectional: bool = True, max_seq_length: int = 30,
                 dropout: float = 0.5, frame_subsample: int = 2,
                 subsample_threshold: int = 10, dtype=torch.float32,
                 dwconv_kernel=None, fused_mlp=None):
        super().__init__()
        self.backbone_name = backbone
        self.temporal_mode = temporal_mode
        self.num_classes = num_classes
        self.dropout = dropout
        self.frame_subsample = frame_subsample
        self.subsample_threshold = subsample_threshold
        self.dtype = dtype
        kw = ({"apply_head_norm": False, "dwconv_kernel": dwconv_kernel,
               "fused_mlp": fused_mlp, "padding": "VALID"}
              if backbone.startswith("convnext") else {})
        self.backbone = build_backbone(backbone, dtype=dtype, **kw)
        D = feature_dim(backbone)
        self.temporal = build_reference_head(
            temporal_mode, D, num_heads=attention_heads,
            kernel=temporal_kernel_size, rnn_hidden=rnn_hidden_dim,
            rnn_layers=rnn_num_layers, bidirectional=rnn_bidirectional,
            max_seq_length=max_seq_length, dtype=dtype)
        self.fc1 = nn.Linear(D, 512)
        self.bn1 = BatchNorm(512, momentum=0.9, eps=TORCH_EPS, dtype=dtype)
        self.fc2 = nn.Linear(512, 256)
        self.bn2 = BatchNorm(256, momentum=0.9, eps=TORCH_EPS, dtype=dtype)
        self.fc_out = nn.Linear(256, num_classes)

    def forward(self, frames: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """frames [B, T, H, W, 3] (or the reference's [B, 3, T, H, W]) →
        float32 logits [B, num_classes]. ``generator``: the dropout masks'
        source in training."""
        x = canonicalize_video_layout(frames)
        B, T = x.shape[0], x.shape[1]
        if T > self.subsample_threshold and self.frame_subsample > 1:
            x = x[:, :: self.frame_subsample]
            T = x.shape[1]
        dt = self.dtype
        feats = self.backbone(x.reshape((B * T,) + tuple(x.shape[2:])),
                              generator)
        pooled = self.temporal(feats.reshape(B, T, -1).to(dt), generator)
        h = F.relu(self.bn1(linear(pooled.to(dt), self.fc1, dt)))
        h = dropout(h, self.dropout, generator, self.training)
        h = F.relu(self.bn2(linear(h, self.fc2, dt)))
        h = dropout(h, self.dropout, generator, self.training)
        return linear(h, self.fc_out, torch.float32)


def build_reference_model(hyperparams: dict, *, dtype=torch.float32,
                          device=None, dwconv_kernel=None,
                          fused_mlp=None) -> ReferenceVideoClassifier:
    """The model of a checkpoint's ``hyperparams`` contract with the
    reference's fallbacks (convnext_tiny, gru, 3 classes, 4 heads, kernel
    3, a 2-layer bidirectional RNN of 512), on ``device`` (default: the
    card) in eval mode, its weights drawn by ``init_weights`` (seeded 0)
    until a checkpoint is loaded."""
    hp = dict(hyperparams or {})
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    model = ReferenceVideoClassifier(
        backbone=hp.get("base_model", "convnext_tiny"),
        temporal_mode=hp.get("temporal_mode", "gru"),
        num_classes=int(hp.get("num_classes", 3)),
        attention_heads=int(hp.get("attention_heads", 4)),
        temporal_kernel_size=int(hp.get("temporal_kernel_size", 3)),
        rnn_hidden_dim=int(hp.get("rnn_hidden_dim", 512)),
        rnn_num_layers=int(hp.get("rnn_num_layers", 2)),
        rnn_bidirectional=bool(hp.get("rnn_bidirectional", True)),
        dtype=dtype, dwconv_kernel=dwconv_kernel, fused_mlp=fused_mlp)
    init_weights(model, torch.Generator().manual_seed(0))
    return model.to(resolve_device(device)).eval()
