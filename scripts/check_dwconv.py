#!/usr/bin/env python3
"""K2's forward alone (and, on float32, its weight gradient), on one
NVIDIA GPU: a quick check for work on ``ops/csrc/dwconv_hopper.cu`` and
the float32 route of ``ops/csrc/dwconv_wgrad_hopper.cu`` (about a minute,
build included, where ``chip_smoke.py`` takes several).

    python3 scripts/check_dwconv.py [--time] [--float32]

Builds the port's kernels, prints what ``ptxas`` said of K2's sources
(registers, shared memory, spills), then holds the forward kernel of
``dwconv.route`` against ``dwconv7x7_plain`` on bf16 inputs with
``chip_smoke.py``'s rule (one bf16 ulp of the largest output): at the
flagship forward's four stage shapes, at the stage sizes of other frame
sizes (4×4 at 112², 2×2 at 40²), at odd shapes (3×5, 10×6) and at a frame
wider than one column tile (20×130). Each call must take the Hopper kernel
(``hopper_launches``), two runs must agree bit for bit, the plain version
on taps transposed (dy ↔ dx) must land outside, and dx (the kernel on
flipped taps, through the autograd Function) must agree with autograd
through the plain conv. The launch geometry of each shape is printed.

``--float32`` does the same on float32 inputs by ``chip_smoke.py``'s
``check_k2_f32``: the Hopper kernel bit-equal to ``dwconv.cu`` (the route
forced) and to itself over two runs, within 2^-16 of the largest output
of the plain version, dx bit-equal on the two kernels, one channel pair's
taps swapped in the plain version landing outside. Then the weight
gradient on float32 by ``chip_smoke.py``'s ``check_k2_wgrad`` at the
stage shapes and ``K2_WGRAD_F32_ODD`` (an odd shape, and a width of 40,
which stays on ``dwconv_wgrad.cu``): its Hopper route against
``dwconv7x7_wgrad_plain`` relative to Σ|x·g| (1e-6), bit-equal over two
runs, flipped and swapped taps outside, each shape's launch geometry, and
at the stage shapes ``dwconv_wgrad.cu`` too (the route forced).

``--time`` adds per-stage times (CUDA events, median of 10) at the stage
shapes: the Hopper kernel, ``dwconv.cu`` on the same inputs (the route
forced), cuDNN's depthwise ``conv2d`` and the bound, and their sums over
the 18 launches of a forward; with ``--float32`` also the weight gradient
by ``time_k2_wgrad_f32`` (in turns with ``dwconv_wgrad.cu``, beside cuDNN's
float32 ``convolution_backward``, the plain version and the bound).
Imports nothing of JAX. Exits non-zero on a
mismatch or without a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# [N, H, W, C] of a frame wider than a 64-column tile, beside
# chip_smoke.py's stage and odd shapes
WIDE = (4, 20, 130, 64)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_dwconv: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from vision_collision_detection_tpu_torch.ops import _build
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    lib_path = _build.build()
    _build.lib()
    print(f"[build] {time.time() - t0:.1f} s", flush=True)
    for logf in sorted(lib_path.parent.glob("dwconv*.log")):
        for line in logf.read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "smem")):
                print(f"[ptxas {logf.stem}] {line.strip()[:200]}", flush=True)
    print("[card]", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    rows, faults, failed = [], [], []
    record = cs.recorder(rows, failed)
    f32 = "--float32" in sys.argv
    dtype = torch.float32 if f32 else torch.bfloat16
    shapes = [(cs.N_FRAMES, H, H, C) for H, C, _ in cs.STAGES]
    for shape in shapes + list(cs.K2_ODD_SHAPES) + [WIDE]:
        print(f"{list(shape)}: geometry "
              f"{k2.hopper_geometry(*shape, dtype=dtype)}", flush=True)
        x, w, b = cs.k2_inputs(torch, dev, g, shape, dtype)
        gy = torch.randn(shape, generator=g).to(dev, dtype)
        if f32:
            cs.check_k2_f32(torch, x, w, b, gy, record, faults, failed)
        else:
            cs.check_k2(torch, x, w, b, record, faults, failed)
            cs.check_k2_dx(torch, x, w, b, gy, record, failed)
        del x, w, b, gy
        torch.cuda.empty_cache()
    if f32:
        stage_shapes = set(shapes)
        for shape in shapes + list(cs.K2_WGRAD_F32_ODD):
            x = torch.randn(shape, generator=g).to(dev)
            gy = torch.randn(shape, generator=g).to(dev)
            if k2.wgrad_route(x.dtype, shape[-1]) == "hopper":
                print(f"{list(shape)}: wgrad geometry "
                      f"{k2.wgrad_hopper_geometry(*shape, dtype=dtype)}",
                      flush=True)
            cs.check_k2_wgrad(torch, x, gy, record, failed, faults)
            if shape in stage_shapes:
                with cs.swapped((k2, "wgrad_route",
                                 lambda dtype_, C_: "tile")):
                    cs.check_k2_wgrad(torch, x, gy, record, failed)
            del x, gy
            torch.cuda.empty_cache()

    if "--time" in sys.argv:
        sums = {}
        for H, C, blocks in cs.STAGES:
            x, w, b = cs.k2_inputs(torch, dev, g, (cs.N_FRAMES, H, H, C),
                                   dtype)
            if f32:
                new, old = cs.time_k2_f32(torch, x, w, b)
                t = {"hopper": new["ms"], "tile": old["ms"],
                     "cudnn": new["library_ms"], "bound": new["bound_ms"],
                     "plain": new["plain_ms"]}
                by = new["bound_by"]
            else:
                t, by = cs.time_k2(torch, x, w, b)
            for k, v in t.items():
                sums[k] = sums.get(k, 0.0) + v * blocks
            print(f"   [time] [{cs.N_FRAMES}, {H}, {H}, {C}] x{blocks}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
                  + f" ms (bound by {by}); Hopper kernel at "
                  f"{98 * x.numel() / t['hopper'] / 1e9:.1f} TFLOP/s",
                  flush=True)
            del x, w, b
        print("   [time] over the 18 launches: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sums.items()) + " ms", flush=True)
        if f32:
            keys = ("ms", "dwconv_wgrad_cu_ms", "library_ms", "plain_ms",
                    "bound_ms")
            sums = dict.fromkeys(keys, 0.0)
            for H, C, blocks in cs.STAGES:
                shape = (cs.N_FRAMES, H, H, C)
                x = torch.randn(shape, generator=g).to(dev)
                gy = torch.randn(shape, generator=g).to(dev)
                r = cs.time_k2_wgrad_f32(torch, x, gy)
                for k in keys:
                    sums[k] += r[k] * blocks
                print(f"   [time wgrad f32] {list(shape)} x{blocks}: "
                      + ", ".join(f"{k} {r[k]:.4f}" for k in keys)
                      + f" (bound by {r['bound_by']})", flush=True)
                del x, gy
            print("   [time wgrad f32] over the 18 launches: " + ", ".join(
                f"{k} {v:.3f}" for k, v in sums.items()), flush=True)
    print(f"FAILED: {failed}" if failed else "ALL OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
