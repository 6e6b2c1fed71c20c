from vision_collision_detection_tpu_torch.models.video_classifier import (
    VideoClassifierModel,
    build_model,
    canonicalize_video_layout,
)

__all__ = ["VideoClassifierModel", "build_model", "canonicalize_video_layout"]
