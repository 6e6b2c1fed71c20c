"""Frame-backbone registry: the ten backbones of the reference's menu.

Each backbone is an ``nn.Module`` taking NHWC frames [N, H, W, 3] and
returning pooled per-frame float32 features [N, D]. The ViViT widths stand
in ``feature_dim`` only: a ViViT is a whole video model
(``models/vivit.py``), built by ``build_model``, not a frame backbone.
"""

from __future__ import annotations

from vision_collision_detection_tpu_torch.utils.registry import Registry

BACKBONE_REGISTRY = Registry("backbone")

_FEATURE_DIMS = {
    "resnet18": 512,
    "resnet50": 2048,
    "mobilenet_v2": 1280,
    "mobilenet_v3_small": 576,
    "efficientnet_v2_s": 1280,
    "efficientnet_v2_m": 1280,
    "efficientnet_v2_l": 1280,
    "convnext_tiny": 768,
    "convnext_base": 1024,
    "convnext_large": 1536,
    "vivit_tiny": 64,
    "vivit_small": 384,
    "vivit_base": 768,
}


def feature_dim(name: str) -> int:
    if name not in _FEATURE_DIMS:
        raise KeyError(
            f"unknown backbone {name!r}; available: {sorted(_FEATURE_DIMS)}")
    return _FEATURE_DIMS[name]


def build_backbone(kind: str, dtype=None, **kwargs):
    """Instantiate a backbone module by registry key."""
    from vision_collision_detection_tpu_torch.models.backbones import (  # noqa: F401
        convnext,
        efficientnet,
        mobilenet,
        resnet,
    )

    factory = BACKBONE_REGISTRY.get(kind)
    return factory(dtype=dtype, **kwargs)


__all__ = ["BACKBONE_REGISTRY", "feature_dim", "build_backbone"]
