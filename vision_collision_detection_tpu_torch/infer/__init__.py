from vision_collision_detection_tpu_torch.infer.predictor import CollisionPredictor

__all__ = ["CollisionPredictor"]
