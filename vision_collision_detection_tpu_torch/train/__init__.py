from vision_collision_detection_tpu_torch.train.optim import (
    build_optimizer,
    clip_by_global_norm_,
    cosine_annealing_schedule,
    global_norm,
)
from vision_collision_detection_tpu_torch.train.steps import (
    TrainState,
    create_train_state,
    load_pretrained_backbone,
    make_eval_step,
    make_train_step,
    weighted_loss,
)
from vision_collision_detection_tpu_torch.train.notebook import (
    run_notebook_equivalent,
)
from vision_collision_detection_tpu_torch.train.trainer import (
    SingleDeviceStrategy,
    Trainer,
)

__all__ = [
    "run_notebook_equivalent",
    "SingleDeviceStrategy",
    "Trainer",
    "build_optimizer",
    "clip_by_global_norm_",
    "cosine_annealing_schedule",
    "global_norm",
    "TrainState",
    "create_train_state",
    "load_pretrained_backbone",
    "make_eval_step",
    "make_train_step",
    "weighted_loss",
]
