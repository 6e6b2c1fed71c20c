"""The port's dataset statistics (``data/stats.py``) against the JAX
package's ``vision_collision_detection_tpu/data/stats.py`` on the same
encoded clips, one of them unreadable."""

import os

import pandas as pd
import pytest

from vision_collision_detection_tpu.data import stats as jax_stats
from vision_collision_detection_tpu_torch.data import stats
from vision_collision_detection_tpu_torch.media.synthetic import (
    generate_dataset,
)


@pytest.fixture(scope="module")
def metadata(tmp_path_factory):
    """Six tiny clips of two sizes in two splits, a seventh row whose video
    is not a video, and one row whose sensor file is missing (the seventh keeps
    the first row's)."""
    root = tmp_path_factory.mktemp("stats")
    frames = []
    for name, (h, w, fps) in (("a", (48, 64, 10.0)), ("b", (40, 56, 5.0))):
        csv = generate_dataset(str(root / name), clips_per_class=1,
                               num_frames=10, fps=fps, height=h, width=w,
                               splits=("train", "val", "train"), seed=len(name))
        frames.append(pd.read_csv(csv))
    df = pd.concat(frames, ignore_index=True)
    bad = root / "broken.mp4"
    bad.write_bytes(b"not a video")
    row = df.iloc[0].copy()
    row["id"], row["video_path"], row["split"] = "broken", str(bad), "test"
    df = pd.concat([df, row.to_frame().T], ignore_index=True)
    df.loc[1, "sensor_path"] = str(root / "missing.csv")
    return df, root


@pytest.mark.parametrize("kw", [{}, {"max_probe": 3}, {"probe_videos": False}])
def test_dataset_statistics_equal(metadata, kw):
    df, _ = metadata
    got = stats.dataset_statistics(df, **kw)
    want = jax_stats.dataset_statistics(df, **kw)
    assert got == want
    assert got["num_clips"] == 7
    if not kw:
        assert got["unreadable_videos"] == 1
        assert got["resolutions"] == {"64x48": 3, "56x40": 3}
        assert got["sensor_coverage"] == pytest.approx(6 / 7)


def test_render_stats_html_byte_identical(metadata):
    df, root = metadata
    got = stats.render_stats_html(stats.dataset_statistics(df),
                                  str(root / "port" / "stats.html"),
                                  title="clips <7>")
    want = jax_stats.render_stats_html(jax_stats.dataset_statistics(df),
                                       str(root / "jax" / "stats.html"),
                                       title="clips <7>")
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("split", [True, False])
def test_class_distribution_png(metadata, split):
    df, root = metadata
    if not split:
        df = df.drop(columns=["split"])
    for mod, name in ((stats, "port"), (jax_stats, "jax")):
        out = mod.plot_class_distribution(df, str(root / f"{name}_{split}.png"))
        with open(out, "rb") as f:
            assert f.read(4) == b"\x89PNG"
    assert os.path.getsize(out) > 0
