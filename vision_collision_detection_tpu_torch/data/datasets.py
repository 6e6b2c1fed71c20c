"""Clip datasets and their factories.

Counterpart of ``vision_collision_detection_tpu/data/datasets.py``: a
path-based dataset whose samples are **raw uint8 letterboxed frames**
(decoded and scaled on the host by the C++ library, ``media/``); the float
conversion and normalisation run later on the device (``ops/preprocess.py``).
``get_batch`` decodes a whole batch in one native call. Clips that do not
decode become zero frames flagged ``error``, as in the reference; a media
library that cannot be built is not such a clip and raises
(``MediaBuildError``). pandas is imported inside the functions that need it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from vision_collision_detection_tpu_torch.data.metadata import (
    add_split_column_to_metadata,
    compute_class_weights,
    find_video_path,
)
from vision_collision_detection_tpu_torch.media.decoder import (
    MediaError,
    decode_batch,
    decode_frames,
    probe,
)
from vision_collision_detection_tpu_torch.media.sampler import sample_clip_indices
from vision_collision_detection_tpu_torch.media.sensors import load_synced_sensor

DEFAULT_CLASS_NAMES = ("Normal", "Near Collision", "Collision")


@dataclasses.dataclass
class ClipRecord:
    video_id: str
    video_path: str
    label: int
    sensor_path: str = ""
    event_time_sec: Optional[float] = None


class ClipDataset:
    """Indexable clip dataset yielding fixed-shape uint8 samples.

    Sample dict:
      frames  uint8 [T, S, S, 3]  (letterboxed by the decoder)
      sensor  float32 [T, 4]
      target  int64
      id      str
      error   bool  (True → zero-frames fallback, as in the reference)
    """

    def __init__(
        self,
        records: Sequence[ClipRecord],
        *,
        fps: int = 10,
        duration: int = 5,
        frame_size: int = 224,
        sample_strategy: str = "center",
        load_sensor: bool = False,
        is_train: bool = False,
        seed: int = 42,
        class_names: Sequence[str] = DEFAULT_CLASS_NAMES,
        frame_stride: int = 1,
        content_box: Optional[tuple] = None,
        fast_resize: bool = False,
        lowres_decode: int = 0,
    ):
        """frame_stride k: decode every k-th frame of the sampled window
        (folding the model's frame subsample into
        decode halves decode + host→device bytes; pair with a model whose
        internal subsample is disabled).

        content_box (h, w): decode into this rectangular letterbox canvas
        instead of the square frame_size — callers ship only content rows
        and pad the black bars on-device (ops.letterbox), cutting transfer
        bytes by the bar fraction (~44% for 16:9 → square).

        fast_resize: planar-YUV fast resize in the decoder (~35% cheaper
        per decoded clip; not bit-exact vs torchvision's resize — see
        media.decoder.set_fast_resize for the bound and parity evidence).

        lowres_decode k: reduced-resolution decode at 1/2^k size for codecs
        that support it (mpeg4/mjpeg/mpeg2; H.264 transparently falls back
        to full-res). Clamped per clip so the decoded frame still covers
        the letterbox content box. Not bit-exact vs full-res decode — see
        media.decoder.set_lowres for the accuracy/parity evidence."""
        self.records = list(records)
        self.fps = fps
        self.duration = duration
        self.frame_size = frame_size
        self.frames_needed = fps * duration
        self.sample_strategy = sample_strategy
        self.load_sensor = load_sensor
        self.is_train = is_train
        self.seed = seed
        self.class_names = tuple(class_names)
        self.frame_stride = max(1, int(frame_stride))
        self.content_box = tuple(content_box) if content_box else None
        self.fast_resize = bool(fast_resize)
        self.lowres_decode = int(lowres_decode)
        self._probe_cache: Dict[str, tuple] = {}

    @property
    def out_frames(self) -> int:
        return -(-self.frames_needed // self.frame_stride)

    @property
    def out_hw(self) -> tuple:
        if self.content_box:
            return self.content_box
        return (self.frame_size, self.frame_size)

    def __len__(self) -> int:
        return len(self.records)

    def labels(self) -> np.ndarray:
        return np.array([r.label for r in self.records], dtype=np.int64)

    def class_weights(self) -> np.ndarray:
        return compute_class_weights(self.labels(), len(self.class_names))

    def _probe(self, path: str):
        if path not in self._probe_cache:
            info = probe(path)
            self._probe_cache[path] = (info.num_frames, info.fps)
        return self._probe_cache[path]

    def get(self, idx: int, epoch: int = 0) -> dict:
        """Fetch sample; `epoch` decorrelates random sampling across epochs
        while staying reproducible (the reference seeds everything at 42)."""
        rec = self.records[idx]
        T = self.frames_needed
        T_out = self.out_frames
        oh, ow = self.out_hw
        try:
            num_frames, vfps = self._probe(rec.video_path)
            rng = np.random.default_rng((self.seed, epoch, idx))
            window = sample_clip_indices(
                self.sample_strategy, num_frames, T,
                video_fps=vfps, event_time_sec=rec.event_time_sec, rng=rng,
            )
            indices = window[:: self.frame_stride]
            frames = decode_frames(
                rec.video_path, indices,
                target_size=(self.content_box or self.frame_size),
                letterbox=True, fast_resize=self.fast_resize,
                lowres=self.lowres_decode,
            )
            if self.load_sensor:
                full = load_synced_sensor(rec.sensor_path, vfps, num_frames)
                start = int(window[0])
                seg = full[start:start + T]
                if len(seg) < T:
                    pad = np.repeat(
                        seg[-1:] if len(seg) else np.zeros((1, 4), np.float32),
                        T - len(seg), axis=0,
                    )
                    seg = np.concatenate([seg, pad], axis=0)
                sensor = seg[:: self.frame_stride].astype(np.float32)
            else:
                sensor = np.zeros((T_out, 4), dtype=np.float32)
            return {
                "frames": frames, "sensor": sensor,
                "target": np.int64(rec.label), "id": rec.video_id,
                "error": False,
            }
        except (MediaError, OSError, ValueError):
            # zero-tensor fallback keeps throughput when clips are broken,
            # as in the reference
            return {
                "frames": np.zeros((T_out, oh, ow, 3), dtype=np.uint8),
                "sensor": np.zeros((T_out, 4), dtype=np.float32),
                "target": np.int64(rec.label), "id": rec.video_id,
                "error": True,
            }

    __getitem__ = get

    supports_batch = True

    def get_batch(self, idxs: Sequence[int], epoch: int = 0,
                  num_threads: int = 0) -> dict:
        """Native batch fetch: ONE C++ call decodes every clip on an internal
        thread pool into a contiguous buffer (no Python per frame) — the
        native replacement for DataLoader worker processes. Returns a
        collated dict (same layout as loader.collate)."""
        T = self.frames_needed
        T_out = self.out_frames
        b = len(idxs)
        paths: list = []
        windows = np.zeros((b, T_out), dtype=np.int64)
        probe_ok = np.ones(b, dtype=bool)
        starts = np.zeros(b, dtype=np.int64)
        fps_list = np.zeros(b, dtype=np.float64)
        nframes = np.zeros(b, dtype=np.int64)
        for j, i in enumerate(idxs):
            rec = self.records[int(i)]
            paths.append(rec.video_path)
            try:
                nf, vfps = self._probe(rec.video_path)
                rng = np.random.default_rng((self.seed, epoch, int(i)))
                window = sample_clip_indices(
                    self.sample_strategy, nf, T, video_fps=vfps,
                    event_time_sec=rec.event_time_sec, rng=rng,
                )
                windows[j] = window[:: self.frame_stride]
                starts[j] = window[0]
                fps_list[j] = vfps
                nframes[j] = nf
            except (MediaError, OSError, ValueError):
                probe_ok[j] = False

        frames, decode_ok = decode_batch(
            paths, windows, self.content_box or self.frame_size,
            letterbox=True, num_threads=num_threads,
            fast_resize=self.fast_resize, lowres=self.lowres_decode,
        )
        ok = probe_ok & decode_ok
        if not ok.all():
            frames[~ok] = 0

        sensor = np.zeros((b, T_out, 4), dtype=np.float32)
        if self.load_sensor:
            for j, i in enumerate(idxs):
                if not ok[j]:
                    continue
                rec = self.records[int(i)]
                full = load_synced_sensor(
                    rec.sensor_path, fps_list[j], int(nframes[j])
                )
                seg = full[int(starts[j]):int(starts[j]) + T]
                if len(seg) < T:
                    pad = np.repeat(
                        seg[-1:] if len(seg) else np.zeros((1, 4), np.float32),
                        T - len(seg), axis=0,
                    )
                    seg = np.concatenate([seg, pad], axis=0)
                sensor[j] = seg[:: self.frame_stride]

        return {
            "frames": frames,
            "sensor": sensor,
            "target": np.asarray(
                [self.records[int(i)].label for i in idxs], dtype=np.int64
            ),
            "id": [self.records[int(i)].video_id for i in idxs],
            "error": ~ok,
            "pad": np.zeros(b, dtype=bool),
        }

    def show_batch(self, out_dir: str, indices: Optional[Sequence[int]] = None,
                   max_clips: int = 4, fps: Optional[float] = None) -> str:
        """Preview-export a few samples (the first ``max_clips``, or
        ``indices``) as MP4s + an HTML grid (``obs.viz.export_batch_preview``).
        Returns the HTML path."""
        from vision_collision_detection_tpu_torch.data.loader import collate
        from vision_collision_detection_tpu_torch.obs.viz import (
            export_batch_preview,
        )

        idx = list(indices) if indices is not None else list(
            range(min(max_clips, len(self)))
        )
        batch = collate([self.get(i) for i in idx])
        return export_batch_preview(
            batch, out_dir, fps=fps or self.fps, max_clips=max_clips
        )


def _records_from_df(
    df: pd.DataFrame,
    class_names: Sequence[str],
    video_path_column: str = "video_path",
    label_column: str = "video_type",
    id_column: str = "id",
    sensor_path_column: str = "sensor_path",
    time_column: str = "event_time_sec",
) -> List[ClipRecord]:
    import pandas as pd

    name_to_idx = {n: i for i, n in enumerate(class_names)}
    records = []
    for _, row in df.iterrows():
        label = row[label_column]
        if not isinstance(label, (int, np.integer)):
            if label not in name_to_idx:
                raise ValueError(f"unknown class label {label!r}")
            label = name_to_idx[label]
        t = row.get(time_column)
        spath = row.get(sensor_path_column, "")
        records.append(ClipRecord(
            video_id=str(row[id_column]),
            video_path=str(row[video_path_column]),
            label=int(label),
            sensor_path=str(spath) if isinstance(spath, str) else "",
            event_time_sec=float(t) if t is not None and not pd.isna(t) else None,
        ))
    return records


def create_datasets_with_manual_split(
    metadata_df: pd.DataFrame,
    *,
    split_column: str = "split",
    class_names: Sequence[str] = DEFAULT_CLASS_NAMES,
    fps: int = 10,
    duration: int = 5,
    frame_size: int = 224,
    train_strategy: str = "random",
    eval_strategy: str = "center",
    load_sensor: bool = False,
    seed: int = 42,
    **column_overrides,
):
    """Column-driven (train, val, test) datasets — the reference's gen-3b
    contract."""
    if split_column not in metadata_df.columns:
        raise ValueError(f"metadata has no {split_column!r} column")
    splits = set(metadata_df[split_column].unique())
    unknown = splits - {"train", "val", "test"}
    if unknown:
        raise ValueError(f"unknown split values: {sorted(unknown)}")

    out = []
    for split, strategy, is_train in (
        ("train", train_strategy, True),
        ("val", eval_strategy, False),
        ("test", eval_strategy, False),
    ):
        df = metadata_df[metadata_df[split_column] == split]
        records = _records_from_df(df, class_names, **column_overrides)
        out.append(ClipDataset(
            records, fps=fps, duration=duration, frame_size=frame_size,
            sample_strategy=strategy, load_sensor=load_sensor,
            is_train=is_train, seed=seed, class_names=class_names,
        ))
    return tuple(out)


def create_datasets_from_directories(
    metadata_df: pd.DataFrame,
    video_dirs: Sequence[str],
    *,
    id_column: str = "id",
    label_column: str = "video_type",
    class_names: Sequence[str] = DEFAULT_CLASS_NAMES,
    min_samples_per_class: int = 5,
    train_frac: float = 0.70,
    val_frac: float = 0.15,
    seed: int = 42,
    **dataset_kwargs,
):
    """Directory-scanning factory with existence filtering, small-class
    dropping, and a stratified 70/15/15 split — the primary-dataset factory
    behavior."""
    import pandas as pd

    rows = []
    for _, row in metadata_df.iterrows():
        info = find_video_path(str(row[id_column]), video_dirs)
        if info["found"]:
            r = dict(row)
            r["video_path"] = info["video_path"]
            r["sensor_path"] = info["sensor_path"] or ""
            rows.append(r)
    df = pd.DataFrame(rows)
    if len(df) == 0:
        raise ValueError("no videos found in the given directories")

    counts = df[label_column].value_counts()
    keep = counts[counts >= min_samples_per_class].index
    df = df[df[label_column].isin(keep)].reset_index(drop=True)

    df = add_split_column_to_metadata(
        df, label_column=label_column, train_frac=train_frac,
        val_frac=val_frac, seed=seed,
    )
    return create_datasets_with_manual_split(
        df, class_names=class_names, seed=seed,
        id_column=id_column, label_column=label_column, **dataset_kwargs,
    )


# The reference's name for it.
create_datasets_with_multiple_dirs = create_datasets_from_directories
