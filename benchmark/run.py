"""One run of one cell of the port's benchmark.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with a CUDA card. The cell (``BENCHMARK.json``)
names its configuration and traffic files; the traffic's ``kind`` picks
the driver (``benchmark/serve.py`` or ``benchmark/train.py``). With
``--trace 0`` the result line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, each read by its file under
``benchmark/metrics/``. The last lines on standard error, and the last key
of the result line (``compared``), give each number compared for
``correct`` beside its limit. The last line on standard output is the
result. A run without a card, or whose process holds JAX or the JAX
package once the window has closed, exits with 2 or 3 and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.harness import log  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def drive(w: dict, seed: int, seconds: float, trace: bool, device: str,
          t_start: float, fault=None) -> dict:
    """Run cell ``w`` and → the driver's record (its window, its traced
    slice where asked, and the numbers compared with their limits)."""
    kind = w["t"]["kind"]
    if kind == "serve":
        from benchmark import serve as driver
    elif kind == "train":
        from benchmark import train as driver
    else:
        raise SystemExit(f"unknown traffic kind {kind!r}")
    return driver.run({"w": w, "seed": seed, "seconds": seconds,
                       "trace": trace, "device": device, "t_start": t_start,
                       "fault": fault})


def correct(rec: dict) -> bool:
    return all(rec["numbers"][k] <= lim for k, lim in rec["limits"].items())


def result(w: dict, rec: dict, man: dict, trace: bool, device_info: dict) -> dict:
    entries = harness.metrics_of(w["name"], man, trace)
    metrics = harness.read_metrics(entries, rec)
    out = {"correct": correct(rec), "attempted": rec["attempted"],
           "failed": int(rec["numbers"].get("answers_missing", 0)),
           "metrics": metrics, "device": device_info}
    if trace and "slice" in rec:
        from benchmark.trace import breakdown

        out["device"] = dict(device_info, busy_s=rec["slice"]["busy_s"],
                             window_s=rec["slice"]["window_s"])
        out["breakdown"] = breakdown(rec["slice"])
    out["compared"] = {k: {"value": rec["numbers"][k], "limit": lim}
                       for k, lim in rec["limits"].items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    harness.cache_dirs(harness.ROOT)
    man = harness.manifest()
    w = harness.cell(args.workload, man)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        log(f"benchmark: the cell needs {w['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
            "available")
        return 2
    rec = drive(w, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        log(f"benchmark: the process holds {found}")
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": w["chips"], "memory_peak_bytes": int(rec["peak_bytes"])}
    out = result(w, rec, man, bool(args.trace), info)
    for k, v in out["compared"].items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
