"""The port's label ETL (``data/etl.py``) against the JAX package's
``vision_collision_detection_tpu/data/etl.py`` on the same label exports
and stand-in video files."""

import json
import sys

import pandas as pd
import pytest

from vision_collision_detection_tpu.data import etl as jax_etl
from vision_collision_detection_tpu_torch.data import etl

CLASSES = ["Normal"] * 7 + ["Near Collision"] * 3 + ["Collision"] * 4


def _labels(i, cls):
    # one event time missing, so the jitter leaves that row alone
    return {"video_id": f"clip{i}", "classification": cls,
            "event_time_sec": None if i == 8 else 0.4 + i * 0.3,
            "annotator": "x"}


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    """A label export as a list and as a dict under "labels", and a video
    root where clip 3 has no file and clip 5 is a .mov."""
    root = tmp_path_factory.mktemp("etl")
    labels = [_labels(i, c) for i, c in enumerate(CLASSES)]
    paths = {}
    for name, doc in (("list", labels), ("dict", {"labels": labels})):
        paths[name] = str(root / f"labels_{name}.json")
        with open(paths[name], "w") as f:
            json.dump(doc, f)
    videos = root / "videos"
    videos.mkdir()
    for i in range(len(CLASSES)):
        if i != 3:  # existence only
            (videos / f"clip{i}{'.mov' if i == 5 else '.mp4'}").write_bytes(b"x")
    return paths, str(videos), root


@pytest.mark.parametrize("form", ["list", "dict"])
def test_load_label_export_matches_jax(export, form):
    paths, _, _ = export
    got, want = etl.load_label_export(paths[form]), jax_etl.load_label_export(
        paths[form])
    pd.testing.assert_frame_equal(got, want)
    assert list(got.columns) == ["id", "video_type", "event_time_sec"]


@pytest.mark.parametrize("kw", [
    {},
    {"jitter_sec": 2.5, "copies": 3, "only_classes": ("Collision",)},
    {"copies": 1, "only_classes": ("Near Collision", "Normal"), "seed": 7},
])
def test_jitter_matches_jax(export, kw):
    df = etl.load_label_export(export[0]["list"])
    got = etl.jitter_event_times(df, **kw)
    want = jax_etl.jitter_event_times(df, **kw)
    pd.testing.assert_frame_equal(got, want)
    assert (got["event_time_sec"].dropna() >= 0).all()


@pytest.mark.parametrize("strategy", ["downsample", "upsample"])
@pytest.mark.parametrize("seed", [42, 3])
def test_balance_matches_jax(export, strategy, seed):
    df = etl.load_label_export(export[0]["list"])
    got = etl.balance_classes(df, strategy=strategy, seed=seed)
    want = jax_etl.balance_classes(df, strategy=strategy, seed=seed)
    pd.testing.assert_frame_equal(got, want)
    assert got["video_type"].value_counts().nunique() == 1


@pytest.mark.parametrize("kw", [
    {},
    {"jitter_copies": 1, "balance": "downsample", "seed": 5},
    {"jitter_classes": ("Collision",), "balance": "upsample",
     "train_frac": 0.6, "val_frac": 0.2},
])
def test_build_training_csv_byte_identical(export, kw):
    paths, videos, root = export
    tag = str(abs(hash(tuple(sorted(kw.items())))))
    got = etl.build_training_csv(paths["dict"], videos,
                                 str(root / "port" / tag / "meta.csv"), **kw)
    want = jax_etl.build_training_csv(paths["dict"], videos,
                                      str(root / "jax" / tag / "meta.csv"),
                                      **kw)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    df = pd.read_csv(got)
    assert "clip3" not in set(df["id"])
    assert df.loc[df["id"] == "clip5", "video_path"].str.endswith(".mov").all()
    assert set(df["split"]) <= {"train", "val", "test"}


def test_presigned_urls_needs_boto3(monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)
    for mod in (etl, jax_etl):
        with pytest.raises(RuntimeError, match="boto3 is not installed"):
            mod.presigned_urls(["a"], "bucket")
