from vision_collision_detection_tpu_torch.ckpt.checkpoint import (
    CheckpointStore,
    load_checkpoint,
)

__all__ = ["CheckpointStore", "load_checkpoint"]
