"""``scripts/run_training_torch.sh``, the port's launcher: each mode through
a stand-in ``PYTHON`` that records its arguments, against the same mode of
the JAX package's ``scripts/run_training.sh``; one real ``test`` run and one
real ``check`` on the CPU."""

import os
import shlex
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_SCRIPT = ROOT / "scripts" / "run_training_torch.sh"
JAX_SCRIPT = ROOT / "scripts" / "run_training.sh"

# Answers ``-c`` (the device count) with STUB_DEVICES and records every other
# call's arguments, one line each.
STUB = """#!/bin/sh
if [ "$1" = "-c" ]; then echo "$STUB_DEVICES"; exit 0; fi
printf '%s\\n' "$*" >> "$STUB_LOG"
"""


@pytest.fixture(scope="module")
def stub(tmp_path_factory):
    d = tmp_path_factory.mktemp("stub")
    path = d / "python"
    path.write_text(STUB)
    path.chmod(0o755)
    return path


def _run(script, args, stub, tmp_path, devices=4, **env):
    log = tmp_path / f"{script.stem}.log"
    if log.exists():
        log.unlink()
    e = dict(os.environ, PYTHON=str(stub), STUB_DEVICES=str(devices),
             STUB_LOG=str(log), **env)
    for k in ("DEVICE", "METADATA_CSV", "VIDEO_DIRS", "BATCH_SIZE"):
        if k not in env:
            e.pop(k, None)
    out = subprocess.run(["bash", str(script), *args], env=e, cwd=tmp_path,
                         capture_output=True, text=True, timeout=60)
    calls = log.read_text().splitlines() if log.exists() else []
    return out, [shlex.split(c) for c in calls]


def _after_module(call, package):
    """The arguments after ``-m <package>.cli.<command>``, and the command."""
    i = call.index("-m", call.index("-m") + 1) if call[:1] == ["-m"] and \
        call[1] == "torch.distributed.run" else call.index("-m")
    module = call[i + 1]
    assert module.startswith(f"{package}.cli."), module
    return module[len(package) + 1:], call[i + 2:]


ENV = {"BACKBONE": "resnet18", "TEMPORAL_MODE": "pooling", "EPOCHS": "2",
       "VIDEO_DIRS": "v1 v2", "METADATA_CSV": "meta.csv"}


@pytest.mark.parametrize("mode", ["single", "grid-search", "test"])
@pytest.mark.parametrize("device", ["", "cpu"])
def test_modes_run_the_ports_commands(stub, tmp_path, mode, device):
    """Each mode runs the JAX script's command with the port's package, and
    with DEVICE set, ``--device`` last."""
    env = dict(ENV, DEVICE=device) if device else dict(ENV)
    got, calls = _run(PORT_SCRIPT, [mode], stub, tmp_path, **env)
    want, jax_calls = _run(JAX_SCRIPT, [mode], stub, tmp_path, **ENV)
    assert got.returncode == want.returncode == 0, got.stderr
    assert len(calls) == len(jax_calls) == 1
    cmd, args = _after_module(calls[0], "vision_collision_detection_tpu_torch")
    jax_cmd, jax_args = _after_module(jax_calls[0],
                                      "vision_collision_detection_tpu")
    assert cmd == jax_cmd == ("cli.grid_search" if mode == "grid-search"
                              else "cli.train")
    expected = jax_args
    if device:
        # --device follows the common arguments (grid-search: before its
        # axes)
        at = (jax_args.index("--backbones") if mode == "grid-search"
              else len(jax_args))
        if mode == "single":
            at = jax_args.index("--single-device")
        expected = jax_args[:at] + ["--device", device] + jax_args[at:]
    assert args == expected


@pytest.mark.parametrize("n,devices,nproc", [
    (None, 4, 4),   # N omitted: every card
    ("0", 4, 4),
    ("2", 4, 2),    # below the count: clamped to N
    ("4", 4, 4),
    ("8", 4, 4),    # above the count: the cards there are
    (None, 1, 1),
])
def test_distributed_clamps_and_echoes_the_real_batch(stub, tmp_path, n,
                                                      devices, nproc):
    args = ["distributed"] + ([n] if n is not None else [])
    out, calls = _run(PORT_SCRIPT, args, stub, tmp_path, devices=devices,
                      BATCH_SIZE="3", DEVICE="cuda")
    assert out.returncode == 0, out.stderr
    assert f"effective global batch: {3 * nproc}" in out.stdout
    assert ("clamping" in out.stdout) == (n is not None and
                                          0 < int(n) < devices)
    (call,) = calls
    assert call[:5] == ["-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", str(nproc)]
    cmd, rest = _after_module(call, "vision_collision_detection_tpu_torch")
    assert cmd == "cli.train"
    assert rest[-4:] == ["--device", "cuda", "--data-parallel", "--test"]
    assert "--batch-size" in rest and rest[rest.index("--batch-size") + 1] == "3"


def test_jax_script_echoes_n_not_the_width(stub, tmp_path):
    """The reference fault the port's echo repairs: the JAX script prints
    BATCH_SIZE × N, 0 when N is omitted and more than the cards when N is
    above their count."""
    out, _ = _run(JAX_SCRIPT, ["distributed"], stub, tmp_path, BATCH_SIZE="3")
    assert "effective global batch: 0" in out.stdout
    out, _ = _run(JAX_SCRIPT, ["distributed", "8"], stub, tmp_path,
                  BATCH_SIZE="3")
    assert "effective global batch: 24" in out.stdout


def test_distributed_without_a_card_fails(stub, tmp_path):
    out, calls = _run(PORT_SCRIPT, ["distributed", "2"], stub, tmp_path,
                      devices=0)
    assert out.returncode == 1 and not calls
    assert "no CUDA device" in out.stdout


@pytest.mark.parametrize("args", [[], ["nope"]])
def test_usage_exits_1(stub, tmp_path, args):
    got, calls = _run(PORT_SCRIPT, args, stub, tmp_path)
    want, _ = _run(JAX_SCRIPT, args, stub, tmp_path)
    assert got.returncode == want.returncode == 1 and not calls
    assert got.stdout.startswith("Usage: ") and "DEVICE" in got.stdout
    # the same modes and lines as the JAX script's usage, DEVICE added
    assert got.stdout.replace(str(PORT_SCRIPT), "$0").replace(
        " SAMPLE_STRATEGY DEVICE", " SAMPLE_STRATEGY") == want.stdout.replace(
        str(JAX_SCRIPT), "$0")


def _real_env(tmp_path, **more):
    env = dict(os.environ, PYTHON=sys.executable, PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS="2", **more)
    for k in ("METADATA_CSV", "VIDEO_DIRS"):
        if k not in more:
            env.pop(k, None)
    return env


def test_check_reports_and_fails_on_a_missing_path(tmp_path):
    ok = subprocess.run(["bash", str(PORT_SCRIPT), "check"], cwd=tmp_path,
                        env=_real_env(tmp_path, VIDEO_DIRS=str(tmp_path)),
                        capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr
    lines = ok.stdout.splitlines()
    assert any(line.startswith("torch ") and "CUDA available: False" in line
               for line in lines)
    assert "package 0.1.0 imports OK" in lines
    lib = [line for line in lines if line.startswith("media library: ")]
    assert lib and Path(lib[0].split(": ", 1)[1]).is_file()
    assert lines[-1] == "check passed"
    bad = subprocess.run(["bash", str(PORT_SCRIPT), "check"], cwd=tmp_path,
                         env=_real_env(tmp_path, METADATA_CSV="nope.csv"),
                         capture_output=True, text=True, timeout=300)
    assert bad.returncode == 1
    assert "ERROR: missing nope.csv" in bad.stdout


def test_test_mode_trains_on_the_cpu(tmp_path):
    """``DEVICE=cpu`` ``test``: synthetic clips, one epoch, ``test()``."""
    env = _real_env(tmp_path, DEVICE="cpu", BACKBONE="resnet18",
                    TEMPORAL_MODE="pooling",
                    SAVE_DIR=str(tmp_path / "runs"))
    out = subprocess.run(["bash", str(PORT_SCRIPT), "test"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    run = tmp_path / "runs_test" / "smoke"
    for name in ("best", "last", "test_results.json", "test_predictions.csv"):
        assert (run / name).exists(), name
