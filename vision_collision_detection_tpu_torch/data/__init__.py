from vision_collision_detection_tpu_torch.data.datasets import (
    ClipDataset,
    ClipRecord,
    create_datasets_from_directories,
    create_datasets_with_manual_split,
)
from vision_collision_detection_tpu_torch.data.loader import (
    ClipLoader,
    collate,
    device_feed,
)
from vision_collision_detection_tpu_torch.data.metadata import (
    add_peak_acceleration_timestamps,
    add_split_column_to_metadata,
    compute_class_weights,
    convert_absolute_to_relative_time,
    find_video_path,
    infer_directory_structure,
)

__all__ = [
    "ClipDataset",
    "ClipRecord",
    "create_datasets_from_directories",
    "create_datasets_with_manual_split",
    "ClipLoader",
    "collate",
    "device_feed",
    "add_peak_acceleration_timestamps",
    "add_split_column_to_metadata",
    "compute_class_weights",
    "convert_absolute_to_relative_time",
    "find_video_path",
    "infer_directory_structure",
]
