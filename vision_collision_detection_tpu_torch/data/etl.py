"""Offline label ETL: raw label exports → training metadata CSV.

Counterpart of ``vision_collision_detection_tpu/data/etl.py``: parse a
label-export JSON, resolve each clip's video file, add time-jittered copies
of the event rows, balance the classes, and write the metadata CSV with a
stratified split column that the datasets read. ``presigned_urls`` needs
boto3, an optional dependency. pandas is imported inside the functions, so
this module imports where pandas is not installed.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from vision_collision_detection_tpu_torch.data.metadata import (
    add_split_column_to_metadata,
)


def load_label_export(path: str,
                      class_field: str = "classification",
                      id_field: str = "video_id",
                      time_field: str = "event_time_sec"):
    """Parse a label-export JSON (a list of {video_id, classification,
    event_time_sec, ...}, or a dict holding one under "labels") into a
    DataFrame with the columns id, video_type, event_time_sec."""
    import pandas as pd

    with open(path) as f:
        raw = json.load(f)
    if isinstance(raw, dict):
        raw = raw.get("labels", list(raw.values()))
    rows = []
    for item in raw:
        rows.append({
            "id": str(item[id_field]),
            "video_type": item[class_field],
            "event_time_sec": item.get(time_field),
        })
    return pd.DataFrame(rows)


def jitter_event_times(df,
                       jitter_sec: float = 1.0,
                       copies: int = 2,
                       only_classes: Optional[Sequence[str]] = None,
                       time_column: str = "event_time_sec",
                       seed: int = 42):
    """Row-duplication time-jitter augmentation: each event row (of
    ``only_classes`` where given) gains ``copies`` duplicates with the
    event time shifted uniformly within ±jitter_sec (clamped at 0)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    out = [df]
    eligible = df
    if only_classes is not None:
        eligible = df[df["video_type"].isin(only_classes)]
    eligible = eligible[eligible[time_column].notna()]
    for _ in range(copies):
        dup = eligible.copy()
        dup[time_column] = np.maximum(
            0.0,
            dup[time_column].to_numpy()
            + rng.uniform(-jitter_sec, jitter_sec, len(dup)),
        )
        out.append(dup)
    return pd.concat(out, ignore_index=True)


def balance_classes(df,
                    label_column: str = "video_type",
                    strategy: str = "downsample",
                    seed: int = 42):
    """Class balancing: down-sample the larger classes to the smallest's
    count, or up-sample (with replacement) the smaller ones to the
    largest's; the rows are then shuffled."""
    import pandas as pd

    counts = df[label_column].value_counts()
    target = counts.min() if strategy == "downsample" else counts.max()
    parts = []
    for label, n in counts.items():
        sub = df[df[label_column] == label]
        if strategy == "downsample" and n > target:
            parts.append(sub.sample(n=target, random_state=seed))
        elif strategy == "upsample" and n < target:
            extra = sub.sample(n=target - n, replace=True, random_state=seed)
            parts.append(pd.concat([sub, extra]))
        else:
            parts.append(sub)
    return pd.concat(parts).sample(frac=1.0, random_state=seed).reset_index(
        drop=True
    )


def build_training_csv(
    labels_json: str,
    video_root: str,
    out_csv: str,
    *,
    jitter_sec: float = 1.0,
    jitter_copies: int = 2,
    jitter_classes: Sequence[str] = ("Collision", "Near Collision"),
    balance: str = "",
    train_frac: float = 0.70,
    val_frac: float = 0.15,
    seed: int = 42,
) -> str:
    """The whole pipeline: labels → each id's ``<video_root>/<id>.mp4`` or
    ``.mov`` (rows without a file dropped) → jitter → balance (``balance``
    "downsample" or "upsample"; none when empty) → stratified split → CSV.
    Returns ``out_csv``."""
    df = load_label_export(labels_json)
    resolved = []
    for _, row in df.iterrows():
        for ext in (".mp4", ".mov"):
            p = os.path.join(video_root, row["id"] + ext)
            if os.path.exists(p):
                resolved.append(p)
                break
        else:
            resolved.append("")
    df["video_path"] = resolved
    df = df[df["video_path"] != ""].reset_index(drop=True)

    df = jitter_event_times(
        df, jitter_sec=jitter_sec, copies=jitter_copies,
        only_classes=jitter_classes, seed=seed,
    )
    if balance:
        df = balance_classes(df, strategy=balance, seed=seed)
    df = add_split_column_to_metadata(
        df, train_frac=train_frac, val_frac=val_frac, seed=seed
    )
    os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
    df.to_csv(out_csv, index=False)
    return out_csv


def presigned_urls(video_ids: Sequence[str], bucket: str,
                   prefix: str = "", expires_sec: int = 3600) -> Dict[str, str]:
    """S3 presigned URLs of ``<prefix><id>.mp4`` in ``bucket``; requires
    boto3 (``RuntimeError`` without it)."""
    try:
        import boto3  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "boto3 is not installed in this environment; presigned_urls is "
            "an optional integration"
        ) from e
    s3 = boto3.client("s3")
    return {
        vid: s3.generate_presigned_url(
            "get_object",
            Params={"Bucket": bucket, "Key": f"{prefix}{vid}.mp4"},
            ExpiresIn=expires_sec,
        )
        for vid in video_ids
    }
