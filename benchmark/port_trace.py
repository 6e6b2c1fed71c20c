"""What the port's spans and counters say about one traced run, beyond the
result line.

The result line of ``benchmark.run --trace 1`` reads the port's spans
(``vcd.<layer>.<phase>``, ``obs/profiling.annotate``) through its metric
files, and ``trace.summarise`` names the slice's idle gaps by them. This
module reads what the line does not hold, for one traced run of a cell
read in full:

    python3 -m benchmark.port_trace --workload <name> --seed <n> --seconds <s> [--out FILE]

runs the cell as ``benchmark.run --trace 1`` does and prints its result
line with a ``port`` key added: the spans' other readings over the traced
slice (``span_readings``: the serving loop's wait for the card, the
training phases' host and device time), the slice's idle time by the span
that names each gap (``idle_by_start_s``) and instant by instant
(``idle_over_spans_s``), the feed's counters over the slice, and the
traced batches' or steps' time against the window's (what tracing costs
with the profiler on). Times in the Chrome trace are in µs.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from typing import Dict, List

from benchmark import harness, trace
from benchmark.readers import slice_units


def idle_by_span(gaps: List[tuple]) -> Dict[str, float]:
    """The gaps' seconds summed by the span that names them."""
    out: Dict[str, float] = {}
    for name, _, sec in gaps:
        out[name] = out.get(name, 0.0) + sec
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_over_spans(events: List[dict], gaps: List[tuple]) -> Dict[str, float]:
    """The gaps' seconds put down, instant by instant, to the innermost span
    open on the host then: a gap that opens in a request's last wait for
    the card and lasts through the next request's fill is split among the
    spans it spans."""
    spans = [s[:3] for s in trace.host_spans(events)]
    cuts = sorted({t for _, s, e in spans for t in (s, e)})
    out: Dict[str, float] = {}
    for _, g0, sec in gaps:
        g1 = g0 + sec * 1e6
        inner = cuts[bisect.bisect_right(cuts, g0):bisect.bisect_left(cuts, g1)]
        points = [g0, *inner, g1]
        for a, b in zip(points, points[1:]):
            name = trace._open_span(spans, a)
            out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def span_readings(summary: dict, kind: str, units: int) -> Dict[str, float]:
    """The port's spans over a traced slice of ``units`` batches (serving)
    or steps (training), in ms a unit, where no metric file reads them:
    the serving loop's wait for the card, each training phase's host time
    and the device time launched in each span."""
    total: Dict[str, float] = {}
    for name, s, e in summary["program_spans"]:
        total[name] = total.get(name, 0.0) + (e - s) * 1e-3
    get = lambda n: total.get(n, 0.0) / units  # noqa: E731
    if kind == "serve":
        return {"result_wait_ms.serve": get("vcd.serve.result_wait")}
    return {**{f"{n}_host_ms": get(n) for n in (
                "vcd.train.preprocess", "vcd.train.forward",
                "vcd.train.backward")},
            **{f"{n}_device_ms": 1e3 * v / units
               for n, v in summary["span_device_s"].items()}}


def feed_readings(delta: Dict[str, int]) -> Dict[str, float]:
    """ms a batch in ``stage`` and waiting on the loader, and pinned MiB a
    feed (a serving request's), from the ``device_feed`` counters' deltas
    (``harness.counter_delta``: a counter that did not move is absent)."""
    d = {k: delta.get(f"device_feed.{k}", 0)
         for k in harness.COUNTERS["device_feed"][2]}
    n = max(d["batches"], 1)
    return {"feed_stage_ms": d["stage_ns"] / n * 1e-6,
            "feed_next_ms": d["next_ns"] / n * 1e-6,
            "pin_allocs": d["pin_allocs"], "batches": d["batches"],
            "feeds": d["feeds"],
            "feed_pinned_mib": d["pinned_bytes"] / max(d["feeds"], 1) / 2 ** 20}


def port_record(rec: dict, events: List[dict]) -> dict:
    """The ``port`` key of a traced run's line: ``rec`` is the driver's
    record (its slice's summary and counters), ``events`` its slice's
    trace."""
    kind, s = rec["kind"], rec["slice"]
    units = slice_units(rec)
    gaps = s["gaps"]
    idle = sum(g[2] for g in gaps)
    over = idle_over_spans(events, gaps)
    out = {"span_readings": span_readings(s, kind, units),
           "idle_s": idle,
           "idle_by_start_s": idle_by_span(gaps),
           "idle_over_spans_s": over,
           "idle_share_over_spans": {k: v / idle for k, v in over.items()}
           if idle else {},
           "feed_slice": feed_readings(rec["slice_counters"])}
    window_units = rec["batches"] if kind == "serve" else rec["steps"]
    unit = "batch" if kind == "serve" else "step"
    out[f"traced_{unit}_ms"] = 1e3 * s["window_s"] / units
    out[f"window_{unit}_ms"] = 1e3 * rec["window_s"] / window_units
    if kind == "serve":
        req = [(e - b) * 1e-3 for n, b, e, _ in trace.host_spans(events)
               if n == trace.REQUEST]
        lat = rec["latencies_s"]
        out["traced_request_mean_ms"] = sum(req) / len(req)
        out["window_request_mean_ms"] = 1e3 * sum(lat) / len(lat)
    return out


def main(argv=None) -> int:
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    from benchmark import run

    harness.cache_dirs(harness.ROOT)
    man = harness.manifest()
    w = harness.cell(args.workload, man)
    import torch

    if not torch.cuda.is_available():
        harness.log("port_trace: no CUDA card")
        return 2
    kept: dict = {}
    summarise = trace.summarise

    def keep_events(events, window_s):
        kept["events"] = events
        return summarise(events, window_s)

    trace.summarise = keep_events
    try:
        rec = run.drive(w, args.seed, args.seconds, True, "cuda", t_start)
    finally:
        trace.summarise = summarise
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": w["chips"], "memory_peak_bytes": int(rec["peak_bytes"])}
    out = run.result(w, rec, man, True, info)
    out["port"] = port_record(rec, kept["events"])
    line = json.dumps(out)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps({"workload": w["name"], "seed": args.seed,
                                **out}) + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
