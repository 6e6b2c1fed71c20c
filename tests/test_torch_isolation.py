"""The port imports neither JAX nor anything of the JAX package."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

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
    bad = [f"{p.relative_to(ROOT)}:{line} imports {name}"
           for p in files for line, name in _imported_roots(p)
           if name in FORBIDDEN]
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


def test_chip_smoke_modules_import_without_pandas_or_matplotlib():
    """The card's machine has neither pandas nor matplotlib: what
    chip_smoke.py imports, and the whole port, loads with both blocked."""
    modules = _chip_smoke_modules()
    assert {"vision_collision_detection_tpu_torch.ckpt.checkpoint",
            "vision_collision_detection_tpu_torch.data.loader"} <= set(modules)
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
