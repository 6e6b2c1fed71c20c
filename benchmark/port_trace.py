"""What the port's own spans and counters say about a run.

The port names its spans ``vcd.<layer>.<phase>`` (``obs/profiling.annotate``)
and counts its device feed's producer thread, which a trace of the main
thread does not show, on ``device_feed``'s attributes. ``trace.summarise``
keeps neither: it reads the benchmark's spans, and ``harness.COUNTERS`` holds
the kernels' launch counters. This module reads both, for the feed's metric
files and for one traced run of a cell read in full:

    python3 -m benchmark.port_trace --workload <name> --seed <n> --seconds <s> [--out FILE]

runs the cell as ``benchmark.run --trace 1`` does, prints its result line
with a ``port`` key added: the readings of the port's spans over the traced
slice (``span_readings``), the feed's counters over the slice, the slice's
idle time by the innermost span open at each gap's start, benchmark's or
port's (``named_gaps``, the breakdown's rule), and instant by instant
(``idle_over_spans``), and the traced batches' or steps' time against
the window's (what tracing costs with the profiler on). Times in the
Chrome trace are in µs.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from typing import Dict, List, Optional

from benchmark import trace

PORT = "vcd."
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
FEED = ("feeds", "batches", "next_ns", "stage_ns", "pin_allocs",
        "pinned_bytes")


def feed_counters() -> Optional[Dict[str, int]]:
    """``device_feed``'s counters as they stand, or None where the program
    has none."""
    from vision_collision_detection_tpu_torch.data import loader

    f = loader.device_feed
    if not all(hasattr(f, k) for k in FEED):
        return None
    return {k: int(getattr(f, k)) for k in FEED}


def host_spans(events: List[dict], port_only: bool = False) -> List[tuple]:
    """(name, start, end, tid) of every host span: the port's (``vcd.*``)
    and, unless ``port_only``, the benchmark's (``trace.SPANS``)."""
    out = []
    for e in events:
        name = e.get("name", "")
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and (
                name.startswith(PORT) or (not port_only and name in trace.SPANS)):
            ts = float(e.get("ts", 0))
            out.append((name, ts, ts + float(e.get("dur", 0)), e.get("tid")))
    return out


def program_spans(events: List[dict]) -> List[tuple]:
    """(name, start, end) of every ``vcd.*`` span."""
    return [s[:3] for s in host_spans(events, port_only=True)]


def span_device_s(events: List[dict]) -> Dict[str, float]:
    """For each ``vcd.*`` span name, the seconds of device activity
    (kernels, copies, memsets) whose launching runtime or driver call lies
    inside an open span of that name on the same host thread. A device
    event names its launch by ``args.correlation``."""
    launch = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS and corr is not None:
            launch[corr] = (float(e.get("ts", 0)), e.get("tid"))
    by_key: Dict[tuple, List[tuple]] = {}
    for name, s, e, tid in host_spans(events, port_only=True):
        by_key.setdefault((name, tid), []).append((s, e))
    for v in by_key.values():
        v.sort()
    starts = {k: [s for s, _ in v] for k, v in by_key.items()}
    out: Dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS:
            continue
        at = launch.get((e.get("args") or {}).get("correlation"))
        if at is None:
            continue
        t, tid = at
        for (name, stid), spans in by_key.items():
            if stid != tid:
                continue
            i = bisect.bisect_right(starts[(name, stid)], t) - 1
            if i >= 0 and t < spans[i][1]:
                out[name] = out.get(name, 0.0) + float(e.get("dur", 0)) * 1e-6
    return out


def named_gaps(events: List[dict]) -> List[tuple]:
    """(name, start, seconds) of the device's idle gaps inside the slice,
    bounded as ``trace.summarise`` bounds them, each named by the innermost
    span, the benchmark's or the port's, open on the host at its start."""
    device = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATS:
            ts = float(e.get("ts", 0))
            device.append((ts, ts + float(e.get("dur", 0))))
    spans = [s[:3] for s in host_spans(events)]
    busy = trace._union(device)
    top = [s for s in spans if s[0] in (trace.REQUEST, trace.STEP)]
    if top:
        lo = min(s[1] for s in top)
        hi = max(max(s[2] for s in top), busy[-1][1] if busy else 0.0)
    else:
        lo = busy[0][0] if busy else 0.0
        hi = busy[-1][1] if busy else 0.0
    inside = [(max(s, lo), min(e, hi)) for s, e in busy if e > lo and s < hi]
    gaps, prev = [], lo
    for s, e in inside + [(hi, hi)]:
        if s > prev:
            gaps.append((trace._open_span(spans, prev), prev, (s - prev) * 1e-6))
        prev = max(prev, e)
    return gaps


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
    spans = [s[:3] for s in host_spans(events)]
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


def span_readings(events: List[dict], kind: str, units: int) -> Dict[str, float]:
    """The readings of the port's spans over a traced slice of ``units``
    batches (serving) or steps (training), in ms a unit."""
    total: Dict[str, float] = {}
    for name, s, e in program_spans(events):
        total[name] = total.get(name, 0.0) + (e - s) * 1e-3
    get = lambda n: total.get(n, 0.0) / units  # noqa: E731
    if kind == "serve":
        return {"feed_wait_ms.serve": get("vcd.feed.wait"),
                "forward_issue_ms.serve": get("vcd.serve.forward"),
                "emit_ms.serve": get("vcd.serve.emit")
                - get("vcd.serve.result_wait"),
                "result_wait_ms.serve": get("vcd.serve.result_wait")}
    dev = span_device_s(events)
    return {"feed_wait_ms.train": get("vcd.feed.wait"),
            "preprocess_ms.train": 1e3 * dev.get("vcd.train.preprocess", 0.0)
            / units,
            "optimizer_host_ms.train": get("vcd.train.optimizer"),
            **{f"{n}_host_ms": get(n) for n in (
                "vcd.train.preprocess", "vcd.train.forward",
                "vcd.train.backward")},
            **{f"{n}_device_ms": 1e3 * v / units for n, v in dev.items()}}


def feed_readings(delta: Dict[str, int]) -> Dict[str, float]:
    """ms a batch in ``stage`` and waiting on the loader, and pinned MiB a
    feed (a serving request's), from counter deltas."""
    n = max(delta["batches"], 1)
    return {"feed_stage_ms": delta["stage_ns"] / n * 1e-6,
            "feed_next_ms": delta["next_ns"] / n * 1e-6,
            "pin_allocs": delta["pin_allocs"], "batches": delta["batches"],
            "feeds": delta["feeds"],
            "feed_pinned_mib": delta["pinned_bytes"]
            / max(delta["feeds"], 1) / 2 ** 20}


def port_record(rec: dict, events: List[dict], feed: Optional[dict]) -> dict:
    """The ``port`` key of a traced run's line: ``rec`` is the driver's
    record, ``events`` its slice's trace, ``feed`` the feed's counter
    deltas over the slice (None where the program has none)."""
    kind = rec["kind"]
    units = rec["slice_batches"] if kind == "serve" else rec["slice_steps"]
    gaps = named_gaps(events)
    idle = sum(g[2] for g in gaps)
    by_start, over = idle_by_span(gaps), idle_over_spans(events, gaps)
    out = {"span_readings": span_readings(events, kind, units),
           "idle_s": idle,
           "idle_by_start_s": by_start,
           "idle_over_spans_s": over,
           "idle_share_over_spans": {k: v / idle for k, v in over.items()}
           if idle else {},
           "idle_gaps": [[n, sec] for n, _, sec in
                         sorted(gaps, key=lambda g: -g[2])[:10]],
           "span_device_s": span_device_s(events)}
    if feed is not None:
        out["feed_slice"] = feed_readings(feed)
    window_units = rec["batches"] if kind == "serve" else rec["steps"]
    unit = "batch" if kind == "serve" else "step"
    out[f"traced_{unit}_ms"] = 1e3 * rec["slice"]["window_s"] / units
    out[f"window_{unit}_ms"] = 1e3 * rec["window_s"] / window_units
    if kind == "serve":
        req = [(e - s) * 1e-3 for n, s, e, _ in host_spans(events)
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
    from benchmark import harness, run

    harness.cache_dirs(harness.ROOT)
    man = harness.manifest()
    w = harness.cell(args.workload, man)
    import torch

    if not torch.cuda.is_available():
        harness.log("port_trace: no CUDA card")
        return 2
    kept: dict = {}
    summarise, profile = trace.summarise, trace.profile

    def keep_events(events, window_s):
        kept["events"] = events
        return summarise(events, window_s)

    def counted(fn):
        before = feed_counters()
        out = profile(fn)
        after = feed_counters()
        if before is not None:
            kept["feed"] = {k: after[k] - before[k] for k in FEED}
        return out

    trace.summarise, trace.profile = keep_events, counted
    try:
        rec = run.drive(w, args.seed, args.seconds, True, "cuda", t_start)
    finally:
        trace.summarise, trace.profile = summarise, profile
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": w["chips"], "memory_peak_bytes": int(rec["peak_bytes"])}
    out = run.result(w, rec, man, True, info)
    out["port"] = port_record(rec, kept["events"], kept.get("feed"))
    line = json.dumps(out)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps({"workload": w["name"], "seed": args.seed,
                                **out}) + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
