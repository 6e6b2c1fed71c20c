from vision_collision_detection_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    create_mesh,
    maybe_initialize_distributed,
    sync_global_devices,
)
from vision_collision_detection_tpu_torch.parallel.dp import (
    DataParallelStrategy,
    to_host_numpy,
)
from vision_collision_detection_tpu_torch.parallel.tp import (
    ModelParallelStrategy,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "create_mesh",
    "maybe_initialize_distributed",
    "sync_global_devices",
    "DataParallelStrategy",
    "ModelParallelStrategy",
    "to_host_numpy",
]
