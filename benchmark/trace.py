"""The traced slice: ``torch.profiler`` over a fixed number of requests or
steps, read back from its Chrome trace.

The benchmark's own spans are ``torch.profiler.record_function`` ranges
(``SPANS``), recorded by the profiler on the host's timeline beside the
device's kernels, copies and memsets. From them:

- ``busy_s``: the union of the device's intervals (overlapping kernels and
  copies on other streams counted once);
- ``kernels``: (name, start, seconds) of each kernel;
- ``gaps``: the device's idle intervals inside the slice, each named by the
  innermost benchmark span open on the host when it began;
- ``fills``: for each request span, the time from its start to the first
  device activity after it.

The trace file goes to a temporary directory (under ``TMPDIR``) and is
deleted once read.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Dict, List

REQUEST, FETCH, STEP = "bench.request", "bench.fetch", "bench.train_step"
SPANS = (REQUEST, FETCH, STEP)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


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


def summarise(events: List[dict], window_s: float) -> Dict:
    """The slice's numbers from Chrome-trace events (times in µs)."""
    device, kernels, spans = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            if cat == "kernel":
                kernels.append((e.get("name", ""), ts, dur * 1e-6))
        elif cat == "user_annotation" and e.get("name") in SPANS:
            spans.append((e["name"], ts, ts + dur))
    busy = _union(device)
    top = [s for s in spans if s[0] in (REQUEST, STEP)]
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
            gaps.append((_open_span(spans, prev), (s - prev) * 1e-6))
        prev = max(prev, e)
    starts = sorted(s for s, _ in busy)
    fills = []
    for name, s, _ in spans:
        if name == REQUEST:
            nxt = next((t for t in starts if t >= s), None)
            if nxt is not None:
                fills.append((nxt - s) * 1e-6)
    return {"busy_s": busy_s, "window_s": window_s, "kernels": kernels,
            "gaps": gaps, "fills": fills,
            "spans": {n: sum(1 for s in spans if s[0] == n) for n in SPANS}}


def _open_span(spans, t) -> str:
    """The innermost benchmark span open at ``t`` on the host."""
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else "outside_spans"


def breakdown(summary: Dict, n: int = 10) -> Dict:
    """The ``breakdown`` of a result line: the device operations that took
    the most time (summed by kernel name) and the longest idle gaps by the
    host's span."""
    by_name: Dict[str, float] = {}
    for name, _, sec in summary["kernels"]:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + sec
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(summary["gaps"], key=lambda g: -g[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def kernel_seconds(summary: Dict, patterns) -> tuple:
    """(launches, device seconds) of the kernels whose name holds any of
    ``patterns``."""
    hits = [sec for name, _, sec in summary["kernels"]
            if any(p in name for p in patterns)]
    return len(hits), sum(hits)
