from vision_collision_detection_tpu_torch.media.build import MediaBuildError
from vision_collision_detection_tpu_torch.media.decoder import (
    MediaError,
    VideoInfo,
    decode_frames,
    encode_video,
    probe,
)
from vision_collision_detection_tpu_torch.media.sampler import sample_clip_indices
from vision_collision_detection_tpu_torch.media.sensors import (
    load_synced_sensor,
    peak_acceleration_time,
    read_sensor_csv,
)

__all__ = [
    "MediaBuildError",
    "MediaError",
    "VideoInfo",
    "decode_frames",
    "encode_video",
    "probe",
    "sample_clip_indices",
    "load_synced_sensor",
    "peak_acceleration_time",
    "read_sensor_csv",
]
