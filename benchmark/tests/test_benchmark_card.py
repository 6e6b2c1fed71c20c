"""Each cell run end to end on the card, as the check runs it, with a short
window: ``python -m pytest benchmark/tests -m card`` on a machine with a
CUDA card (skips elsewhere). Every metric a cell lists reads a number, with
``--trace 1`` the per-layer ones."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(name, trace, card):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name,
         "--seed", str(2 ** 31 + 77), "--seconds", "3", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    wanted = {m["name"] for m in harness.metrics_of(name, harness.manifest(),
                                                    bool(trace))}
    assert set(res["metrics"]) == wanted
    if trace:
        assert res["device"]["busy_s"] > 0
        assert {"mfu.serve", "mfu.train"} & set(res["metrics"])
        # the idle gaps are named by the port's spans where they were open
        assert any(n.startswith("vcd.") for n, _ in res["breakdown"]["idle_gaps"])
