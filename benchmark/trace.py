"""The traced slice: ``torch.profiler`` over a fixed number of requests or
steps, read back from its Chrome trace.

The benchmark's own spans are ``torch.profiler.record_function`` ranges
(``SPANS``), the port's are its ``vcd.*`` ranges; the profiler records
both on the host's timeline beside the device's kernels, copies and
memsets, and the runtime calls that launched them. From them:

- ``busy_s``: the union of the device's intervals (overlapping kernels and
  copies on other streams counted once);
- ``kernels``: (name, start, seconds) of each kernel;
- ``gaps``: (name, start, seconds) of the device's idle intervals inside
  the slice, each named by the innermost span, the benchmark's or the
  port's, open on the host when it began;
- ``fills``: for each request span, the time from its start to the first
  device activity after it;
- ``spans``: how many of each benchmark span;
- ``program_spans``: (name, start, end) of each of the port's spans;
- ``span_device_s``: for each of the port's span names, the device seconds
  launched inside such a span (``span_device_s``).

The trace file goes to a temporary directory (under ``TMPDIR``) and is
deleted once read.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Callable, Dict, List

REQUEST, FETCH, STEP = "bench.request", "bench.fetch", "bench.train_step"
SPANS = (REQUEST, FETCH, STEP)
PORT = "vcd."  # the port's spans: ``vcd.<layer>.<phase>`` (obs/profiling.annotate)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def span(name: str):
    import torch

    return torch.profiler.record_function(name)


def profile(run: Callable[[], None]) -> Dict:
    """Run ``run`` under the profiler (CPU and CUDA activity) → its events,
    and the slice's wall time on the host clock (ending in a
    synchronise)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return summarise(events, window_s)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def host_spans(events: List[dict], port_only: bool = False) -> List[tuple]:
    """(name, start, end, tid) of every host span: the port's (``vcd.*``)
    and, unless ``port_only``, the benchmark's (``SPANS``)."""
    out = []
    for e in events:
        name = e.get("name", "")
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and (
                name.startswith(PORT) or (not port_only and name in SPANS)):
            ts = float(e.get("ts", 0))
            out.append((name, ts, ts + float(e.get("dur", 0)), e.get("tid")))
    return out


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
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
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


def summarise(events: List[dict], window_s: float) -> Dict:
    """The slice's numbers from Chrome-trace events (times in µs)."""
    device, kernels = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            if cat == "kernel":
                kernels.append((e.get("name", ""), ts, dur * 1e-6))
    spans = [s[:3] for s in host_spans(events)]
    bench = [s for s in spans if s[0] in SPANS]
    busy = _union(device)
    top = [s for s in bench if s[0] in (REQUEST, STEP)]
    if top:
        lo = min(s[1] for s in top)
        hi = max(max(s[2] for s in top), busy[-1][1] if busy else 0.0)
    else:
        lo = busy[0][0] if busy else 0.0
        hi = busy[-1][1] if busy else 0.0
    inside = [(max(s, lo), min(e, hi)) for s, e in busy if e > lo and s < hi]
    busy_s = sum(e - s for s, e in inside) * 1e-6
    gaps, prev = [], lo
    for s, e in inside + [(hi, hi)]:
        if s > prev:
            gaps.append((_open_span(spans, prev), prev, (s - prev) * 1e-6))
        prev = max(prev, e)
    starts = sorted(s for s, _ in busy)
    fills = []
    for name, s, _ in bench:
        if name == REQUEST:
            nxt = next((t for t in starts if t >= s), None)
            if nxt is not None:
                fills.append((nxt - s) * 1e-6)
    return {"busy_s": busy_s, "window_s": window_s, "kernels": kernels,
            "gaps": gaps, "fills": fills,
            "spans": {n: sum(1 for s in bench if s[0] == n) for n in SPANS},
            "program_spans": [s for s in spans if s[0].startswith(PORT)],
            "span_device_s": span_device_s(events)}


def _open_span(spans, t) -> str:
    """The innermost span, the benchmark's or the port's, open at ``t`` on
    the host."""
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else "outside_spans"


def breakdown(summary: Dict, n: int = 10) -> Dict:
    """The ``breakdown`` of a result line: the device operations that took
    the most time (summed by kernel name) and the longest idle gaps, each
    named by the innermost span open on the host at its start."""
    by_name: Dict[str, float] = {}
    for name, _, sec in summary["kernels"]:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + sec
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(summary["gaps"], key=lambda g: -g[2])[:n]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, sec] for k, _, sec in gaps]}


def kernel_seconds(summary: Dict, patterns) -> tuple:
    """(launches, device seconds) of the kernels whose name holds any of
    ``patterns``."""
    hits = [sec for name, _, sec in summary["kernels"]
            if any(p in name for p in patterns)]
    return len(hits), sum(hits)
