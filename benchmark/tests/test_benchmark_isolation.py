"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference and the architectures' modules import nothing of the program. Imports are read from each
module's syntax tree; a name is compared by its top-level part (before the
first dot), whole: the program's package name begins with the JAX
package's."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(harness.__file__).resolve().parent
RUN_MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((BENCH / "reference").glob("*.py"))
ARCHITECTURES = sorted((BENCH / "architectures").glob("*.py"))
PROGRAM = "vision_collision_detection_tpu_torch"


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_every_run_module_is_read():
    names = {p.name for p in RUN_MODULES}
    assert {"run.py", "serve.py", "train.py", "harness.py", "trace.py",
            "models.py", "training.py", "convnext_gru.py", "vivit.py"} <= names
    assert len(list((BENCH / "metrics").glob("*.py"))) >= 16


@pytest.mark.parametrize("path", RUN_MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    found = top_level_imports(path) & set(harness.FORBIDDEN)
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)


@pytest.mark.parametrize("path", ARCHITECTURES, ids=lambda p: p.name)
def test_architectures_import_nothing_of_the_program(path):
    """An architecture's module is reference code: plain PyTorch."""
    assert not top_level_imports(path) & {PROGRAM, *harness.FORBIDDEN}


def test_whole_names_are_compared():
    # the program's name begins with the JAX package's and is not it
    assert PROGRAM.startswith("vision_collision_detection_tpu")
    assert PROGRAM.split(".")[0] not in harness.FORBIDDEN


def test_forbidden_modules_reads_sys_modules(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("flax.linen"))
    assert "flax" in harness.forbidden_modules()
    monkeypatch.delitem(sys.modules, "flax.linen")
    monkeypatch.setitem(sys.modules, PROGRAM + ".ops",
                        types.ModuleType(PROGRAM + ".ops"))
    assert "vision_collision_detection_tpu" not in harness.forbidden_modules()
