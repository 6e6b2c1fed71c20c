"""The flagship model: per-frame CNN backbone + temporal head + MLP classifier.

Counterpart of ``vision_collision_detection_tpu/models/video_classifier.py``:
layout auto-detect, every k-th frame when T exceeds a threshold, B·T frames
through the backbone as one batch, the temporal head, then the classifier
MLP feat → 512 → 256 → num_classes. ``fc1``/``fc2`` run in the compute dtype,
``fc_out`` in float32, as the flax model does.

With ``use_sensor`` the IMU stream [B, T_sensor, 4] is fused in as the
flax model does it: ``sensor_fc1`` → ReLU → ``sensor_fc2`` → ReLU in the
compute dtype, a mean over time (accumulated in float32 and rounded to the
compute dtype, as ``jnp.mean`` of a bf16 array is), then float32,
concatenated after the temporal head's output.

In training (``self.training``, flax's ``train``) the two classifier
dropouts (flax ``drop1``, ``drop2``) and the backbone's drop-path draw their
masks from the ``generator`` passed to ``forward``, never from the global
RNG.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vision_collision_detection_tpu_torch.config import ModelConfig
from vision_collision_detection_tpu_torch.models.backbones import (
    build_backbone,
    feature_dim,
)
from vision_collision_detection_tpu_torch.models.backbones.convnext import (
    DwConv7x7,
    linear,
)
from vision_collision_detection_tpu_torch.models.norm import BatchNorm
from vision_collision_detection_tpu_torch.models.temporal import (
    build_temporal_head,
    dropout,
    temporal_out_dim,
)
from vision_collision_detection_tpu_torch.utils.device import resolve_device

SENSOR_CHANNELS = 4  # accel x, y, z and the total, as media/sensors.py reads


def canonicalize_video_layout(x: torch.Tensor) -> torch.Tensor:
    """Accept [B,T,H,W,C] (native) or [B,C,T,H,W] (reference torch layout):
    a channel-sized (1 or 3) axis 1 with a non-channel last axis means
    channels-first."""
    if x.dim() != 5:
        raise ValueError(f"expected 5-D video batch, got shape {tuple(x.shape)}")
    if x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3):
        x = x.permute(0, 2, 3, 4, 1)
    return x


class VideoClassifierModel(nn.Module):
    def __init__(self, backbone: str = "convnext_tiny",
                 temporal_mode: str = "gru", num_classes: int = 3,
                 hidden_dim: int = 512, temporal_hidden_dim: int = 256,
                 attention_heads: int = 4, max_seq_length: int = 30,
                 bidirectional: bool = True, dropout: float = 0.5,
                 use_sensor: bool = False, sensor_hidden_dim: int = 64,
                 frame_subsample: int = 2, subsample_threshold: int = 10,
                 gelu_approximate: bool = False, dtype=torch.bfloat16,
                 dwconv_kernel=None, fused_mlp=None):
        super().__init__()
        self.use_sensor = use_sensor
        self.frame_subsample = frame_subsample
        self.subsample_threshold = subsample_threshold
        self.dropout = dropout
        self.dtype = dtype
        kw = ({"gelu_approximate": gelu_approximate,
               "dwconv_kernel": dwconv_kernel, "fused_mlp": fused_mlp}
              if backbone.startswith("convnext") else {})
        self.backbone = build_backbone(backbone, dtype=dtype, **kw)
        D = feature_dim(backbone)
        # the JAX model gives the head no dropout rate: its attention
        # head's stays at 0
        self.temporal = build_temporal_head(
            temporal_mode, D, hidden=temporal_hidden_dim,
            num_heads=attention_heads, max_seq_length=max_seq_length,
            bidirectional=bidirectional, dtype=dtype)
        head_out = temporal_out_dim(temporal_mode, D, temporal_hidden_dim)
        if use_sensor:
            self.sensor_fc1 = nn.Linear(SENSOR_CHANNELS, sensor_hidden_dim)
            self.sensor_fc2 = nn.Linear(sensor_hidden_dim, sensor_hidden_dim)
            head_out += sensor_hidden_dim
        self.fc1 = nn.Linear(head_out, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim // 2)
        self.fc_out = nn.Linear(hidden_dim // 2, num_classes)

    def forward(self, frames: torch.Tensor,
                sensor: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``sensor``: the IMU stream [B, T_sensor, 4], required with
        ``use_sensor`` and ignored without. ``generator``: the source of the
        dropout and drop-path masks in training, on the frames' device."""
        if self.use_sensor and sensor is None:
            raise ValueError("use_sensor=True but no sensor input given")
        x = canonicalize_video_layout(frames)
        B, T = x.shape[0], x.shape[1]
        if T > self.subsample_threshold and self.frame_subsample > 1:
            x = x[:, :: self.frame_subsample]
            T = x.shape[1]
        flat = x.reshape((B * T,) + tuple(x.shape[2:]))
        feats = self.backbone(flat, generator)  # [B·T, D] float32
        pooled = self.temporal(feats.reshape(B, T, -1),
                               generator)  # [B, D_out] float32
        dt = self.dtype
        if self.use_sensor:
            s = F.relu(linear(sensor, self.sensor_fc1, dt))
            s = F.relu(linear(s, self.sensor_fc2, dt))
            pooled = torch.cat([pooled, s.mean(dim=1).to(torch.float32)], -1)
        h = F.relu(linear(pooled, self.fc1, dt))
        h = dropout(h, self.dropout, generator, self.training)
        h = F.relu(linear(h, self.fc2, dt))
        h = dropout(h, self.dropout, generator, self.training)
        return linear(h, self.fc_out, torch.float32)


def build_model(cfg: ModelConfig, device=None, dwconv_kernel=None,
                fused_mlp=None,
                generator: Optional[torch.Generator] = None,
                frame_size: Optional[int] = None) -> nn.Module:
    """The model of ``cfg`` on ``device`` (default: the card), in eval mode,
    with weights drawn by ``init_weights`` from ``generator`` (a CPU
    ``torch.Generator``; default: one seeded 0). ``frame_size``: the side of
    the square frames the model will see (default ``cfg.image_size``); a
    ViViT sizes its spatial position table from it, as flax does from the
    input it is initialised on."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if cfg.backbone.startswith("vivit"):
        from vision_collision_detection_tpu_torch.models.vivit import (
            build_vivit,
        )

        model = build_vivit(cfg, frame_size)
        init_weights(model, generator)
        return model.to(dev).eval()
    model = VideoClassifierModel(
        backbone=cfg.backbone, temporal_mode=cfg.temporal_mode,
        num_classes=cfg.num_classes, hidden_dim=cfg.hidden_dim,
        temporal_hidden_dim=cfg.temporal_hidden_dim,
        attention_heads=cfg.attention_heads,
        max_seq_length=cfg.max_seq_length, bidirectional=cfg.bidirectional,
        dropout=cfg.dropout, use_sensor=cfg.use_sensor,
        sensor_hidden_dim=cfg.sensor_hidden_dim,
        frame_subsample=cfg.frame_subsample,
        subsample_threshold=cfg.subsample_threshold,
        gelu_approximate=cfg.gelu_approximate,
        dtype=getattr(torch, cfg.dtype), dwconv_kernel=dwconv_kernel,
        fused_mlp=fused_mlp)
    init_weights(model, generator)
    return model.to(dev).eval()


def _lecun_normal_(t: torch.Tensor, fan_in: int, g: torch.Generator):
    # flax lecun_normal: truncated normal at ±2σ, rescaled to variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)


@torch.no_grad()
def init_weights(model: nn.Module, g: torch.Generator) -> None:
    """Draw every parameter from ``g`` with the flax initialisers' laws:
    lecun-normal kernels, orthogonal recurrent kernels, zero biases, unit
    LayerNorm and BatchNorm scales (running statistics 0 and 1),
    N(0, 0.02²) position tables; layer-scale γ keeps its constructor
    value."""
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in ("spatial_pos", "temporal_pos",
                                       "pos_embedding"):
            nn.init.normal_(p, 0.0, 0.02, generator=g)
    for module in model.modules():
        if isinstance(module, (nn.Conv1d, nn.Conv2d)):
            fan_in = module.weight[0].numel()
            _lecun_normal_(module.weight, fan_in, g)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, DwConv7x7):
            _lecun_normal_(module.weight, 49, g)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, g)
            nn.init.zeros_(module.bias)
        elif isinstance(module, (nn.LayerNorm, BatchNorm)):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
            if isinstance(module, BatchNorm):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        elif isinstance(module, nn.RNNBase):
            gates = {"GRU": 3, "LSTM": 4, "RNN": 1}[type(module).__name__]
            for name, p in module.named_parameters():
                if name.startswith("weight_ih"):
                    _lecun_normal_(p, p.shape[1], g)
                elif name.startswith("weight_hh"):
                    for block in p.chunk(gates, dim=0):
                        nn.init.orthogonal_(block, generator=g)
                else:
                    nn.init.zeros_(p)
