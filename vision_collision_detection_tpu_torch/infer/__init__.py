"""Serving: ``CollisionPredictor`` (``infer/predictor.py``) and its exported
bundles (``infer/aot.py``). The predictor, and with it the model code, is
imported on first use, so that a host that only serves a bundle loads no
model code."""

from vision_collision_detection_tpu_torch.infer.aot import (
    ServingBundle,
    export_bundle,
)

__all__ = ["CollisionPredictor", "ServingBundle", "export_bundle"]


def __getattr__(name):
    if name == "CollisionPredictor":
        from vision_collision_detection_tpu_torch.infer.predictor import (
            CollisionPredictor,
        )

        return CollisionPredictor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
