"""The port imports neither JAX nor anything of the JAX package."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "vision_collision_detection_tpu_torch"
FORBIDDEN = {"jax", "flax", "optax", "orbax", "vision_collision_detection_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_no_forbidden_import_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py"] + [
        ROOT / "scripts" / f"check_{name}.py"
        for name in ("flash_bwd", "flash_fwd", "convnext_mlp")] + [
        ROOT / "scripts" / "probe_serving.py"]
    assert len(files) > 10
    assert {PORT / "models" / "vivit.py",
            PORT / "ops" / "flash_attention.py",
            PORT / "media" / "decoder.py", PORT / "data" / "loader.py",
            PORT / "ckpt" / "checkpoint.py"} <= set(files)
    assert {PORT / "models" / name for name in NEW_MODELS} <= set(files)
    bad = [f"{p.relative_to(ROOT)}:{line} imports {name}"
           for p in files for line, name in _imported_roots(p)
           if name in FORBIDDEN]
    assert not bad, bad


# the BatchNorm backbones, the other heads and the reference import
NEW_MODELS = ("norm.py", "backbones/resnet.py", "backbones/mobilenet.py",
              "backbones/efficientnet.py", "reference_heads.py",
              "reference_model.py", "import_torch.py")


def test_manifests_are_the_ports_own_copy():
    """The torchvision manifests the importer checks against are the
    port's copy, with the JAX package's keys and shapes; no port file
    names the JAX package's manifest directory."""
    import json

    from vision_collision_detection_tpu_torch.models import import_torch

    own = Path(import_torch.MANIFEST_DIR)
    assert own == PORT / "models" / "manifests"
    jax_dir = ROOT / "vision_collision_detection_tpu" / "models" / "manifests"
    names = sorted(p.name for p in jax_dir.glob("*.json"))
    assert len(names) == 10 and sorted(
        p.name for p in own.glob("*.json")) == names
    for name in names:
        ours, theirs = (json.loads((d / name).read_text())["keys"]
                        for d in (own, jax_dir))
        assert ours == theirs, name
    pattern = re.compile(r"vision_collision_detection_tpu[/.]models[/.]"
                         r"manifests|vision_collision_detection_tpu\.models"
                         r"\.convert")
    files = [p for p in PORT.rglob("*") if p.suffix in (".py", ".json")] + [
        ROOT / "chip_smoke.py"]
    bad = [f"{p.relative_to(ROOT)}:{i}" for p in files
           for i, line in enumerate(p.read_text().splitlines(), 1)
           if pattern.search(line)]
    assert not bad, bad


def test_whole_first_component_is_compared():
    names = {n for _, n in _imported_roots(PORT / "models" / "convert.py")}
    assert "vision_collision_detection_tpu_torch" not in FORBIDDEN
    assert "numpy" in names


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'orbax', "
        "'vision_collision_detection_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import pkgutil, importlib\n"
        "import vision_collision_detection_tpu_torch as p\n"
        "for info in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _chip_smoke_modules():
    """Every module of the port that chip_smoke.py imports."""
    names = set()
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("vision_collision_detection_tpu_torch"):
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return sorted(names)


TRAINING_MODULES = [f"vision_collision_detection_tpu_torch.{m}" for m in (
    "train.trainer", "train.notebook", "obs.history", "obs.dashboard",
    "obs.logging_utils", "obs.plots", "parallel", "parallel.mesh",
    "parallel.dp", "parallel.tp")]


def test_chip_smoke_modules_import_without_pandas_or_matplotlib():
    """The card's machine has neither pandas nor matplotlib: what
    chip_smoke.py imports, the training engine and its ``obs`` modules, and
    the whole port, load with both blocked."""
    modules = _chip_smoke_modules()
    assert {"vision_collision_detection_tpu_torch.ckpt.checkpoint",
            "vision_collision_detection_tpu_torch.data.loader",
            "vision_collision_detection_tpu_torch.train.trainer",
            "vision_collision_detection_tpu_torch.infer.predictor",
            "vision_collision_detection_tpu_torch.models.norm",
            "vision_collision_detection_tpu_torch.obs.viz"} <= set(modules)
    modules = sorted(set(modules) | set(TRAINING_MODULES))
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('pandas', 'matplotlib', 'jax', 'flax', "
        "'vision_collision_detection_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for name in {modules!r}:\n"
        "    try:\n"
        "        importlib.import_module(name)\n"
        "    except ModuleNotFoundError:\n"
        "        parent, _, attr = name.rpartition('.')\n"
        "        getattr(importlib.import_module(parent), attr)\n"
        "import chip_smoke\n"
        "import vision_collision_detection_tpu_torch as p\n"
        "for info in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "assert 'pandas' not in sys.modules or sys.modules['pandas'] is None\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_trainer_runs_without_pandas_or_matplotlib(tmp_path):
    """A ``Trainer`` run on the CPU with pandas, matplotlib and JAX blocked,
    as on the card's machine: chip_smoke.py's stand-in dataset, one
    epoch with the cascade, ``test()``; the CSV and JSON artifacts are written, and each
    plot fails with the logged warning the JAX trainer gives."""
    code = (
        "import sys\n"
        "for m in ('pandas', 'matplotlib', 'jax', 'flax', "
        "'vision_collision_detection_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(2)  # beside the other test workers\n"
        "import chip_smoke\n"
        "from vision_collision_detection_tpu_torch.config import "
        "ExperimentConfig\n"
        "from vision_collision_detection_tpu_torch.train import Trainer\n"
        "g = np.random.default_rng(0)\n"
        "def ds(n, broken=None):\n"
        "    clips = g.integers(0, 256, (n, 4, 18, 32, 3), dtype=np.uint8)\n"
        "    return chip_smoke.StandInClips(clips, broken, "
        "labels=np.arange(n) % 3)\n"
        "cfg = ExperimentConfig().override({'data.frame_size': 32, "
        "'data.fps': 2, 'data.duration': 2, 'data.batch_size': 2, "
        "'model.dtype': 'float32', 'train.epochs': 1, "
        "'train.validation_freq': 1, 'train.checkpoint_every_epochs': 0, "
        "'train.log_every_steps': 1})\n"
        f"tr = Trainer(cfg, ds(4, broken=1), ds(2), ds(2), "
        f"run_dir={str(tmp_path / 'run')!r}, device='cpu')\n"
        "tr.train()\n"
        "res = tr.test()\n"
        "assert res['num_samples'] == 2, res\n"
        "assert 'pandas' not in sys.modules or sys.modules['pandas'] is None\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
    run = tmp_path / "run"
    for name in ("training_history.csv", "validation_epoch0.json",
                 "test_results.json", "test_predictions.csv"):
        assert (run / name).exists(), name
    log = (run / "training.log").read_text()
    assert "training-curve plot failed" in log
    assert "confusion-matrix plot failed" in log
    assert not (run / "training_curves.png").exists()
    shutil.rmtree(run)  # two checkpoints of about 360 MB each


def test_no_port_file_names_the_jax_media_sources():
    """The port builds its own media library from its own copy of the
    source; nothing of it reads or writes the JAX package's ``_src``."""
    pattern = re.compile(r"vision_collision_detection_tpu[/.]media[/.]_src"
                         r"|[\"']_src[\"']")
    files = [p for p in PORT.rglob("*") if p.suffix in
             (".py", ".cpp", ".cu", ".cuh")] + [ROOT / "chip_smoke.py"]
    assert PORT / "media" / "csrc" / "vcd_media.cpp" in files
    bad = [f"{p.relative_to(ROOT)}:{i}" for p in files
           for i, line in enumerate(p.read_text().splitlines(), 1)
           if pattern.search(line)]
    assert not bad, bad


# the serving bundle and the command line
SERVING_MODULES = ("infer/aot.py", "ops/library.py", "obs/profiling.py",
                   "cli/__init__.py", "cli/train.py", "cli/infer.py",
                   "cli/grid_search.py", "cli/convert_weights.py")


def _module_level_imports(path: Path):
    """The modules a file imports when it is imported (its top-level
    statements; imports inside functions are left out)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


# the attention view and clip previews, label ETL, dataset statistics
OFFLINE_MODULES = ("obs/viz.py", "data/etl.py", "data/stats.py")


@pytest.mark.parametrize("name", SERVING_MODULES + OFFLINE_MODULES)
def test_serving_and_cli_module_imports(name):
    """Each is scanned for JAX imports above; the bundle's runtime
    (``infer/aot.py``, ``ops/library.py``) loads nothing of the models or
    the predictor, and no command, and none of the offline modules, loads
    pandas or matplotlib (or the widget libraries and boto3) until it needs
    them (the card's machine has neither)."""
    path = PORT / name
    roots = {n for _, n in _imported_roots(path)}
    assert not roots & FORBIDDEN
    imports = list(_module_level_imports(path))
    assert not [m for m in imports if m.split(".")[0] in (
        "pandas", "matplotlib", "ipywidgets", "IPython", "boto3")]
    if name in ("infer/aot.py", "ops/library.py"):
        assert not [m for m in imports if m.startswith(
            ("vision_collision_detection_tpu_torch.models",
             "vision_collision_detection_tpu_torch.infer.predictor"))]
