"""What the metric files under ``benchmark/metrics/`` share.

A metric file defines ``read(ctx)``: ``ctx`` is the driver's record of the
run (its window; with ``--trace 1`` its traced slice (``trace.summarise``),
the program's counters over the slice and the slice's batches or steps).
It returns a number, or None where the run holds nothing to read.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from benchmark import counts
from benchmark.harness import log
from benchmark.trace import kernel_seconds

# (kernel-name patterns that count launches, patterns of helper kernels
# whose time belongs to the same launches, the launches of one unit)
Family = Tuple[Sequence[str], Sequence[str], List[counts.Launch]]


def rate(ctx: dict, kind: str) -> Optional[float]:
    """Clips completed per second over the window's whole time."""
    if ctx.get("kind") != kind:
        return None
    return ctx["clips"] / ctx["window_s"]


def mfu(ctx: dict, kind: str) -> Optional[float]:
    """The model's FLOPs for the window's clips over its time, as a share
    (%) of the bf16 peak."""
    if ctx.get("kind") != kind:
        return None
    f = ctx["clips"] * counts.clip_flops(ctx["c"], kind == "train")
    return 100.0 * f / ctx["window_s"] / counts.BF16_FLOPS


def roofline(ctx: dict, kind: str, name: str,
             families: Sequence[Family]) -> Optional[float]:
    """Σ of the bound time over Σ of the device time of a kernel family's
    launches in the traced slice (%). The launches in the trace must be
    those the configuration's shapes give for the slice's batches or steps;
    where they are not, the reading is left out."""
    if ctx.get("kind") != kind or "slice" not in ctx:
        return None
    units = slice_units(ctx)
    bound = busy = 0.0
    for patterns, helpers, launches in families:
        n, sec = kernel_seconds(ctx["slice"], patterns)
        if n != len(launches) * units or n == 0:
            log(f"{name}: {n} launches of {list(patterns)} in the trace, "
                f"{len(launches) * units} expected: not read")
            return None
        busy += sec + kernel_seconds(ctx["slice"], helpers)[1]
        bound += units * sum(x.bound_s() for x in launches)
    return 100.0 * bound / busy


def slice_units(ctx: dict) -> int:
    """The traced slice's batches (serving) or steps (training)."""
    return ctx["slice_batches"] if ctx["kind"] == "serve" else ctx["slice_steps"]


def span_ms(ctx: dict, kind: str, name: str) -> Optional[float]:
    """ms a batch or a step that the host spent inside the port's spans
    ``name`` in the traced slice (Σ of their lengths / batches or steps);
    None where the slice holds no such span."""
    if ctx.get("kind") != kind or "slice" not in ctx:
        return None
    lengths = [e - s for n, s, e in ctx["slice"]["program_spans"] if n == name]
    if not lengths:
        return None
    return 1e-3 * sum(lengths) / slice_units(ctx)


def span_device_ms(ctx: dict, kind: str, name: str) -> Optional[float]:
    """ms a batch or a step of device time launched inside the port's spans
    ``name`` in the traced slice (``trace.span_device_s``); None where the
    slice holds no such span."""
    if span_ms(ctx, kind, name) is None:
        return None
    return 1e3 * ctx["slice"]["span_device_s"].get(name, 0.0) / slice_units(ctx)


def idle(ctx: dict, kind: str) -> Optional[float]:
    """The device's idle share (%) of the traced slice's wall time."""
    if ctx.get("kind") != kind or "slice" not in ctx:
        return None
    s = ctx["slice"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
