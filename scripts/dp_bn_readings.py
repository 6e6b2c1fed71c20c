"""How far the port's data-parallel BatchNorm statistics fall from the JAX
package's, over several draws of inputs and weights (CPU, gloo).

For each draw this runs ``tests/test_torch_parallel.py``'s references and
ranks (``dp_results``): the JAX ``DataParallelStrategy`` step of resnet18 +
pooling on two virtual CPU devices, whose running statistics are
``pmean``ed, against the port's two ranks over gloo. It prints, per draw,
the largest |port − JAX| over every running mean and variance, and that
error over the test's tolerance 1e-6 + 1e-6·|JAX| (a ratio under 1 passes).
Both sides form the batch variance as E[x²] − E[x]² in float32.

    python scripts/dp_bn_readings.py [--draws "3,0 0,0 1,1 2,2 4,4"]

A draw is ``data_seed,bn_key``; the test's own is ``3,0``. About 40 s a
draw on an 8-core CPU host.
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

TESTS = Path(__file__).resolve().parent.parent / "tests"
sys.path.insert(0, str(TESTS))

import conftest  # noqa: E402,F401  (8 virtual CPU devices for JAX)
import numpy as np  # noqa: E402
import test_torch_parallel as t  # noqa: E402


def readings(ref, got):
    """→ (largest |port − JAX|, largest |port − JAX| / (1e-6 + 1e-6·|JAX|))
    over rank 0's running statistics."""
    stats = t._stats(got[0]["bn_dp_state"])
    worst_abs = worst_ratio = 0.0
    for k, v in stats.items():
        want = np.asarray(ref["bn_state"][k], np.float64)
        err = np.abs(v.numpy().astype(np.float64) - want)
        worst_abs = max(worst_abs, float(err.max()))
        worst_ratio = max(worst_ratio,
                          float((err / (1e-6 + 1e-6 * np.abs(want))).max()))
    return worst_abs, worst_ratio


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", default="3,0 0,0 1,1 2,2 4,4")
    args = ap.parse_args()
    for draw in args.draws.split():
        data_seed, bn_key = (int(x) for x in draw.split(","))
        with tempfile.TemporaryDirectory() as tmp:
            ref, got = t.dp_results(Path(tmp), data_seed, bn_key)
        worst_abs, ratio = readings(ref, got)
        print(f"draw {data_seed},{bn_key}: largest |port - JAX| "
              f"{worst_abs:.3e}; over the tolerance {ratio:.3f}", flush=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
