"""Dataset statistics report.

Counterpart of ``vision_collision_detection_tpu/data/stats.py``:
``dataset_statistics`` computes the numbers (class distribution per split,
video geometry, fps and duration through the port's C++ probe, sensor
coverage); ``render_stats_html`` writes the dashboard page;
``plot_class_distribution`` renders the PNG. pandas and matplotlib are
imported inside the functions that need them.
"""

from __future__ import annotations

import html
import os
from typing import Dict

import numpy as np

from vision_collision_detection_tpu_torch.media.decoder import MediaError, probe


def dataset_statistics(
    metadata_df,
    *,
    label_column: str = "video_type",
    split_column: str = "split",
    video_path_column: str = "video_path",
    sensor_path_column: str = "sensor_path",
    probe_videos: bool = True,
    max_probe: int = 200,
) -> Dict:
    """Statistics of a metadata DataFrame: clip, class and split counts,
    the share of rows whose sensor file exists, and, over the first
    ``max_probe`` videos, resolutions, fps, durations and the count that
    could not be read."""
    df = metadata_df
    stats: Dict = {"num_clips": int(len(df))}
    stats["class_counts"] = df[label_column].value_counts().to_dict()
    if split_column in df.columns:
        stats["split_counts"] = df[split_column].value_counts().to_dict()
        stats["class_by_split"] = {
            split: sub[label_column].value_counts().to_dict()
            for split, sub in df.groupby(split_column)
        }
    if sensor_path_column in df.columns:
        have = df[sensor_path_column].apply(
            lambda p: isinstance(p, str) and len(p) > 0 and os.path.exists(p)
        )
        stats["sensor_coverage"] = float(have.mean())

    if probe_videos and video_path_column in df.columns:
        geoms, fpss, durations, missing = [], [], [], 0
        for p in df[video_path_column].head(max_probe):
            try:
                info = probe(str(p))
                geoms.append((info.width, info.height))
                fpss.append(info.fps)
                durations.append(info.duration)
            except (MediaError, OSError):
                missing += 1
        if geoms:
            stats["resolutions"] = {
                f"{w}x{h}": geoms.count((w, h)) for w, h in set(geoms)
            }
            stats["fps"] = {"min": float(np.min(fpss)),
                            "max": float(np.max(fpss)),
                            "mean": float(np.mean(fpss))}
            stats["duration_sec"] = {"min": float(np.min(durations)),
                                     "max": float(np.max(durations)),
                                     "mean": float(np.mean(durations))}
        stats["unreadable_videos"] = missing
    return stats


def render_stats_html(stats: Dict, out_path: str,
                      title: str = "dataset statistics") -> str:
    """The statistics as an HTML page, a section per key (a table for a
    dict); returns ``out_path``."""
    def table(d: Dict) -> str:
        rows = "".join(
            f"<tr><td>{html.escape(str(k))}</td>"
            f"<td>{html.escape(str(v))}</td></tr>"
            for k, v in d.items()
        )
        return f"<table>{rows}</table>"

    sections = []
    for key, value in stats.items():
        body = table(value) if isinstance(value, dict) else html.escape(str(value))
        sections.append(f"<h3>{html.escape(key)}</h3>{body}")
    doc = (
        "<html><head><style>body{font-family:monospace;background:#181818;"
        "color:#ddd;padding:16px}table{border-collapse:collapse}"
        "td{border:1px solid #444;padding:4px 10px}</style></head><body>"
        f"<h2>{html.escape(title)}</h2>" + "".join(sections) + "</body></html>"
    )
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path


def plot_class_distribution(
    metadata_df, out_path: str,
    label_column: str = "video_type", split_column: str = "split",
) -> str:
    """A bar chart PNG of the clips per class (per split where the
    DataFrame has a split column); returns ``out_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if split_column in metadata_df.columns:
        pivot = metadata_df.groupby(
            [label_column, split_column]
        ).size().unstack(fill_value=0)
    else:
        pivot = metadata_df[label_column].value_counts().to_frame("count")
    ax = pivot.plot.bar(figsize=(7, 4), rot=20)
    ax.set_ylabel("clips")
    ax.grid(alpha=0.3, axis="y")
    fig = ax.get_figure()
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
