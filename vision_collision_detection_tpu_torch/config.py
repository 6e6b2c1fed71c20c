"""Single dataclass config tree for the whole framework.

The port's own copy of ``vision_collision_detection_tpu.config``: the same
fields, defaults and JSON contract, so a config written by either package
reads back in the other with equal results. Checkpoints persist it so
inference can rebuild the architecture.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping

BACKBONES = (
    "resnet18",
    "resnet50",
    "mobilenet_v2",
    "mobilenet_v3_small",
    "efficientnet_v2_s",
    "efficientnet_v2_m",
    "efficientnet_v2_l",
    "convnext_tiny",
    "convnext_base",
    "convnext_large",
    "vivit_tiny",
    "vivit_small",
    "vivit_base",
    "timesformer_tiny",
    "timesformer_hr",
)


def whole_video(backbone: str) -> bool:
    """``backbone`` names a whole video model (``models/vivit.py``,
    ``models/timesformer.py``): it takes every frame of a clip, with no
    frame backbone, temporal head or frame subsampling."""
    return backbone.startswith(("vivit", "timesformer"))


TEMPORAL_MODES = ("attention", "conv", "pooling", "rnn", "lstm", "gru")

SAMPLE_STRATEGIES = ("random", "center", "metadata_time", "uniform")


@dataclass
class DataConfig:
    """Clip-loading configuration."""

    fps: int = 10
    duration: int = 5  # seconds → num_frames = fps * duration
    frame_size: int = 224  # square letterbox target
    sample_strategy: str = "center"  # random | center | metadata_time | uniform
    load_sensor_data: bool = False
    sensor_dim: int = 4  # [accel_x, accel_y, accel_z, total]
    num_classes: int = 3
    class_names: tuple = ("Normal", "Near Collision", "Collision")
    train_frac: float = 0.70
    val_frac: float = 0.15
    test_frac: float = 0.15
    min_samples_per_class: int = 5
    batch_size: int = 8  # per device
    num_workers: int = 8
    prefetch_depth: int = 2
    drop_last_train: bool = True
    seed: int = 42
    # The decoder ships letterbox CONTENT rows only; the bars are padded on
    # the device (the K1 kernel, ops/dequant_pad.py).
    content_box_transfer: bool = True
    fast_resize: bool = False
    lowres_decode: int = 0

    @property
    def num_frames(self) -> int:
        return self.fps * self.duration


@dataclass
class AugmentConfig:
    """Augmentation params; the eval path reads only the normalisation."""

    enabled: bool = True
    aug_probability: float = 0.9
    brightness_range: tuple = (0.9, 1.1)
    contrast_range: tuple = (0.9, 1.1)
    saturation_range: tuple = (0.9, 1.1)
    hue_range: tuple = (-0.05, 0.05)
    rotation_range: tuple = (-7.0, 7.0)  # degrees
    scale_range: tuple = (0.95, 1.1)
    shear_range: tuple = (-2.0, 2.0)  # degrees (x-shear)
    translate_range: tuple = (0.0, 0.07)
    affine_mode: str = "separable"
    grayscale_prob: float = 0.02
    noise_level: float = 0.0
    blur_sigma: float = 0.5
    cutout_prob: float = 0.1
    cutout_count_range: tuple = (1, 2)
    cutout_size_range: tuple = (0.1, 0.15)
    color_inversion_prob: float = 0.0
    solarization_prob: float = 0.0
    solarization_threshold: float = 0.5
    posterization_prob: float = 0.0
    posterization_bits_range: tuple = (3, 6)
    horizontal_flip_prob: float = 0.5
    normalize_mean: tuple = (0.45, 0.45, 0.45)
    normalize_std: tuple = (0.225, 0.225, 0.225)


@dataclass
class ModelConfig:
    """Architecture config."""

    backbone: str = "convnext_tiny"
    temporal_mode: str = "gru"
    num_classes: int = 3
    pretrained: bool = False
    pretrained_path: str = ""
    hidden_dim: int = 512  # classifier MLP: feat → 512 → 256 → num_classes
    temporal_hidden_dim: int = 256  # RNN hidden size / attention dim
    attention_heads: int = 4
    max_seq_length: int = 30
    bidirectional: bool = True
    dropout: float = 0.5
    use_sensor: bool = False
    sensor_hidden_dim: int = 64
    frame_subsample: int = 2  # take every k-th frame when T > subsample_threshold
    subsample_threshold: int = 10
    dtype: str = "bfloat16"  # compute dtype; params stay float32
    gelu_approximate: bool = True  # tanh-approx GELU in the ConvNeXt blocks
    patch_size: int = 14
    image_size: int = 224
    remat: bool = False
    attention_impl: str = "xla"

    def backbone_feature_dim(self) -> int:
        from vision_collision_detection_tpu_torch.models.backbones import (
            feature_dim,
        )

        return feature_dim(self.backbone)


@dataclass
class OptimConfig:
    optimizer: str = "adamw"
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    schedule: str = "cosine"
    cosine_t_max_epochs: int = 30
    eta_min_ratio: float = 0.01
    warmup_steps: int = 0
    grad_clip_norm: float = 0.0  # 0 disables
    loss_type: str = "cross_entropy"  # or "bce"
    label_smoothing: float = 0.0
    use_class_weights: bool = True


@dataclass
class TrainConfig:
    epochs: int = 15
    patience: int = 5
    validation_freq: int = 2
    mini_val_batches: int = 25
    mixed_precision: bool = True
    log_every_steps: int = 10
    checkpoint_every_epochs: int = 1
    keep_checkpoints: int = 3
    seed: int = 42
    resume: bool = False
    deterministic_data: bool = True
    dashboard: bool = False
    profile_steps: int = 0


@dataclass
class MeshConfig:
    data_axis: str = "data"
    model_axis: str = "model"
    num_data: int = -1  # -1 → all devices on the data axis
    num_model: int = 1


@dataclass
class ExperimentConfig:
    """Root config."""

    data: DataConfig = field(default_factory=DataConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    experiment_name: str = ""
    save_dir: str = "runs"
    metadata_csv: str = ""
    video_dirs: tuple = ()

    def name(self) -> str:
        if self.experiment_name:
            return self.experiment_name
        return f"{self.model.backbone}_{self.model.temporal_mode}"

    # ---- serialization (the checkpoint "hyperparams contract") ----

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=_json_default)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentConfig":
        # Back-compat: checkpoints saved before gelu_approximate existed were
        # trained with erf-GELU; rebuild them with the numerics they had.
        if "model" in d and "gelu_approximate" not in d["model"]:
            d = dict(d)
            d["model"] = dict(d["model"], gelu_approximate=False)
        return _dataclass_from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))

    def override(self, dotted: Mapping[str, Any]) -> "ExperimentConfig":
        """Apply {'model.backbone': 'resnet18', ...} style overrides, returning a copy."""
        cfg = self.from_dict(self.to_dict())
        for key, value in dotted.items():
            parts = key.split(".")
            obj = cfg
            for p in parts[:-1]:
                obj = getattr(obj, p)
            leaf = parts[-1]
            if not hasattr(obj, leaf):
                raise KeyError(f"Unknown config key: {key}")
            current = getattr(obj, leaf)
            if current is not None and not isinstance(current, (list, tuple, dict)):
                value = type(current)(value) if value is not None else value
            setattr(obj, leaf, value)
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.model.backbone not in BACKBONES:
            raise ValueError(
                f"backbone {self.model.backbone!r} not in {BACKBONES}"
            )
        if self.model.temporal_mode not in TEMPORAL_MODES:
            raise ValueError(
                f"temporal_mode {self.model.temporal_mode!r} not in {TEMPORAL_MODES}"
            )
        if self.data.sample_strategy not in SAMPLE_STRATEGIES:
            raise ValueError(
                f"sample_strategy {self.data.sample_strategy!r} not in {SAMPLE_STRATEGIES}"
            )
        if self.data.num_classes != self.model.num_classes:
            raise ValueError("data.num_classes must match model.num_classes")
        if self.model.attention_impl not in ("xla", "flash"):
            raise ValueError(
                f"attention_impl {self.model.attention_impl!r} not in "
                "('xla', 'flash')"
            )
        if (self.model.backbone.startswith("timesformer")
                and self.model.attention_impl != "flash"):
            raise ValueError(
                f"{self.model.backbone} attends by K4 only: "
                "model.attention_impl must be 'flash'"
            )
        if not 0 <= int(self.data.lowres_decode) <= 3:
            raise ValueError(
                f"data.lowres_decode {self.data.lowres_decode!r} must be "
                "an int in 0..3"
            )
        if self.augment.affine_mode == "separable":
            # The two-pass warp factors through 1/cos(rotation+shear): keep
            # the sampled angles far from the ±90° singularity.
            worst = (max(abs(a) for a in self.augment.rotation_range)
                     + max(abs(s) for s in self.augment.shear_range))
            if worst > 45.0:
                raise ValueError(
                    f"rotation+shear up to {worst:.1f}° exceeds the "
                    "separable warp's valid regime (|rot+shear| ≤ 45°); "
                    "set augment.affine_mode='gather' for extreme angles"
                )


def _json_default(o):
    if isinstance(o, (tuple, set)):
        return list(o)
    raise TypeError(f"not JSON serializable: {type(o)}")


def _dataclass_from_dict(cls, d):
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in dict(d).items():
        if key not in hints:
            continue  # forward-compat: ignore unknown keys from old checkpoints
        f = hints[key]
        default = (f.default_factory()
                   if f.default_factory is not dataclasses.MISSING
                   else f.default)
        if dataclasses.is_dataclass(default):
            kwargs[key] = _dataclass_from_dict(type(default), value)
        elif isinstance(default, tuple) and isinstance(value, (list, tuple)):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)
