from vision_collision_detection_tpu_torch.metrics.classification import (
    accuracy,
    binary_roc_auc,
    classification_metrics,
    confusion_matrix,
    precision_recall_f1,
    weighted_ovr_auc,
)

__all__ = [
    "accuracy",
    "binary_roc_auc",
    "classification_metrics",
    "confusion_matrix",
    "precision_recall_f1",
    "weighted_ovr_auc",
]
