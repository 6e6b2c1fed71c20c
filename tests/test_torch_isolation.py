"""The port imports neither JAX nor anything of the JAX package."""

import ast
import os
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
        for name in ("flash_bwd", "flash_fwd", "convnext_mlp")]
    assert len(files) > 10
    assert {PORT / "models" / "vivit.py",
            PORT / "ops" / "flash_attention.py"} <= set(files)
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
