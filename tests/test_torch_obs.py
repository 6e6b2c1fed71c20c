"""The port's observability modules against the JAX package's: the training
history and its CSV, the metrics JSON, the predictions CSV (written without
pandas, read back with pandas here), the dashboard, the distributed
factory, the logging setup and the training-curve plot."""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from vision_collision_detection_tpu.obs import history as jax_history
from vision_collision_detection_tpu_torch.obs import history
from vision_collision_detection_tpu_torch.obs.dashboard import (
    TrainingVisualizer,
    _NoOpVisualizer,
    create_distributed_visualizer,
)
from vision_collision_detection_tpu_torch.obs.logging_utils import (
    is_main_process,
    process_rank,
    setup_logging,
)
from vision_collision_detection_tpu_torch.obs.plots import (
    plot_training_curves,
)

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["Normal", "Near Collision", "Collision"]


def _epochs():
    """append_epoch calls as a run makes them: full metrics, a NaN AUC, an
    epoch without validation, numpy scalars, a missing lr."""
    rng = np.random.default_rng(0)

    def val(auc):
        m = {"loss": float(rng.random()), "accuracy": np.float64(0.5),
             "auc": auc, "weighted_precision": 0.25, "weighted_recall": 1 / 3,
             "weighted_f1": np.float32(0.1), "macro_f1": 0.2,
             "confusion_matrix": [[1, 0], [0, 1]], "num_samples": 3}
        for n in ("normal", "near_collision", "collision"):
            m.update({f"precision_{n}": float(rng.random()),
                      f"recall_{n}": 1e-5, f"f1_{n}": 0.0})
        return m

    return [
        ((0, {"loss": 1.0986, "accuracy": np.float32(0.5)}, val(0.75)),
         {"lr": 1e-4, "epoch_time_sec": 12.5}),
        ((1, {"loss": 0.9, "accuracy": 2 / 3}, val(float("nan"))),
         {"lr": 9.5e-5, "epoch_time_sec": 11.0}),
        ((2, {"loss": 0.8, "accuracy": 1.0}, None), {"epoch_time_sec": 3.0}),
        ((3, {"loss": np.float64(0.7), "accuracy": 0.0}, val(1.0)),
         {"lr": 2.5e10}),
    ]


def _both():
    ours, ref = history.TrainingHistory(NAMES), jax_history.TrainingHistory(
        NAMES)
    for args, kw in _epochs():
        ours.append_epoch(*args, **kw)
        ref.append_epoch(*args, **kw)
    return ours, ref


def test_history_records_equal_jax():
    ours, ref = _both()
    assert ours.class_names == ref.class_names
    assert json.dumps(ours.records) == json.dumps(ref.records)  # NaN too
    back = history.TrainingHistory.from_list(["a", "b", "c"], ours.to_list())
    assert json.dumps(back.records) == json.dumps(ours.records)


def test_history_csv_equals_jax(tmp_path):
    ours, ref = _both()
    ours.save_csv(str(tmp_path / "ours" / "h.csv"))
    ref.save_csv(str(tmp_path / "ref" / "h.csv"))
    got = pd.read_csv(tmp_path / "ours" / "h.csv")
    want = pd.read_csv(tmp_path / "ref" / "h.csv")
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert list(got.columns) == list(ref.to_dataframe().columns)
    # the same bytes: pandas' float formats, empty fields for NaN and gaps
    assert (tmp_path / "ours" / "h.csv").read_text() == \
        (tmp_path / "ref" / "h.csv").read_text()
    pd.testing.assert_frame_equal(ours.to_dataframe(), ref.to_dataframe())


def test_predictions_csv_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    probs = rng.dirichlet(np.ones(3), 7).astype(np.float32)
    probs[0] = [1e-8, 0.5, 0.49999997]
    targets = rng.integers(0, 3, 7)
    preds = probs.argmax(1)
    ids = [f"clip,{i}" if i == 2 else f"clip_{i}" for i in range(7)]
    args = (ids, targets, preds, probs, NAMES)
    history.save_predictions_csv(str(tmp_path / "ours.csv"), *args)
    jax_history.save_predictions_csv(str(tmp_path / "ref.csv"), *args)
    got = pd.read_csv(tmp_path / "ours.csv")
    want = pd.read_csv(tmp_path / "ref.csv")
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert (tmp_path / "ours.csv").read_text() == \
        (tmp_path / "ref.csv").read_text()
    assert got["correct"].dtype == bool


def test_metrics_json_equals_jax(tmp_path):
    metrics = {"loss": np.float32(0.25), "accuracy": 0.5,
               "num_samples": np.int64(3), "auc": float("nan"),
               "confusion_matrix": [[1, 2], [3, 4]], "name": "x",
               "arr": np.arange(2)}
    history.save_metrics_json(str(tmp_path / "ours.json"), metrics)
    jax_history.save_metrics_json(str(tmp_path / "ref.json"), metrics)
    assert (tmp_path / "ours.json").read_text() == \
        (tmp_path / "ref.json").read_text()


def test_writers_run_without_pandas(tmp_path):
    """The card's machine has no pandas: the history, the predictions CSV
    and the JSON are written with pandas blocked, and read back here."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        f"sys.path[:0] = [{str(ROOT / 'tests')!r}, {str(ROOT)!r}]\n"
        "import numpy as np\n"
        "from vision_collision_detection_tpu_torch.obs import history\n"
        "h = history.TrainingHistory(['Normal', 'Near Collision', "
        "'Collision'])\n"
        "h.append_epoch(0, {'loss': 1.0}, {'loss': 0.5, 'auc': 0.7}, "
        "lr=1e-4)\n"
        f"h.save_csv({str(tmp_path / 'h.csv')!r})\n"
        f"history.save_predictions_csv({str(tmp_path / 'p.csv')!r}, "
        "['a', 'b'], np.array([0, 2]), np.array([0, 1]), "
        "np.full((2, 3), 1 / 3, np.float32), ['Normal', 'Near Collision', "
        "'Collision'])\n"
        f"history.save_metrics_json({str(tmp_path / 'm.json')!r}, "
        "{'loss': np.float32(0.5)})\n"
        "try:\n"
        "    h.to_dataframe()\n"
        "except ImportError:\n"
        "    print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert list(pd.read_csv(tmp_path / "h.csv").columns) == [
        "epoch", "train_loss", "val_loss", "val_auc", "learning_rate"]
    p = pd.read_csv(tmp_path / "p.csv")
    assert p["correct"].tolist() == [True, False]
    assert json.loads((tmp_path / "m.json").read_text()) == {"loss": 0.5}


def test_dashboard(tmp_path, capsys):
    viz = TrainingVisualizer(total_epochs=2, steps_per_epoch=20,
                             run_dir=str(tmp_path), console=True)
    viz.start_epoch(0)
    for i in range(1, 21):
        viz.update_train_loss(1.0 / i, i)
    viz.update_val_metrics({"loss": 0.5, "accuracy": 0.7})
    viz.update_full_val_metrics({"loss": 0.45, "accuracy": 0.72})
    viz.mark_epoch(0, {"loss": 0.3, "accuracy": 0.8},
                   {"loss": 0.45, "accuracy": 0.72})
    out = capsys.readouterr().out
    assert "epoch 1/2" in out and "it/s" in out
    content = (tmp_path / "dashboard.html").read_text()
    assert "best val loss 0.4500" in content
    assert viz.best_val_loss == 0.45
    assert viz._stats()["ma_loss"] == pytest.approx(
        np.mean([1.0 / i for i in range(1, 21)]))
    assert not hasattr(viz, "display")


def test_distributed_factory_is_real_on_main(tmp_path):
    assert process_rank() == 0 and is_main_process()
    viz = create_distributed_visualizer(1, 10, str(tmp_path))
    assert isinstance(viz, TrainingVisualizer)  # one process is the main one
    noop = _NoOpVisualizer()
    noop.update_train_loss(1.0)  # absorbs anything
    noop.whatever(1, 2, x=3)


def test_setup_logging_writes_the_run_log(tmp_path):
    log = setup_logging(str(tmp_path / "run"), name="vcd_test")
    log.info("hello %d", 7)
    again = setup_logging(str(tmp_path / "run"), name="vcd_test")
    assert again is log and len(log.handlers) == 2  # replaced, not added
    again.warning("second")
    for h in log.handlers:
        h.flush()
    text = (tmp_path / "run" / "training.log").read_text()
    assert "INFO hello 7" in text and "WARNING second" in text
    assert log.propagate is False and log.level == logging.INFO


def test_plot_training_curves(tmp_path):
    ours, _ = _both()
    path = plot_training_curves(ours.to_dataframe(),
                                str(tmp_path / "c.png"))
    assert os.path.getsize(path) > 0
