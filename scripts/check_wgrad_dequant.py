#!/usr/bin/env python3
"""K2's weight gradient and K1 alone, on one NVIDIA GPU: a quick check for
work on ``ops/csrc/dwconv_wgrad_hopper.cu`` and ``ops/csrc/dequant_pad.cu``
(about a minute, build included, where ``chip_smoke.py`` takes several).

    python3 scripts/check_wgrad_dequant.py [--time]

Builds the port's kernels and prints what ``ptxas`` said of the two
sources (registers, shared memory, spills). Then, with ``chip_smoke.py``'s
rules:

- K2 wgrad on the kernel of ``dwconv.wgrad_route`` against
  ``dwconv7x7_wgrad_plain`` on bf16 inputs, relative to Σ|x·g| (1e-6), and
  bit-equal over two runs: at the flagship step's four stage shapes (with
  the taps flipped, and dy and dx swapped, landing outside), at the odd
  shapes of ``chip_smoke.K2_ODD_SHAPES`` and at a frame wider than one
  column tile (20×130); ``dwconv_wgrad.cu`` (the route forced) at the stage
  shapes; the routed kernel on float32 inputs at [8, 56, 56, 96] (the
  Hopper kernel's float32 route; ``check_dwconv.py --float32`` holds it at
  the stages). The Hopper kernel's launch geometry is printed for each
  shape.
- K1 against ``dequant_normalize_pad_plain``, bit-equal, in bf16 and
  float32: the flagship's 200 frames of 126×224 → 224², the ViViT's 256 of
  189×336 → 336², and 64 of 120×213 → 224² (side bars, rows off the 16-byte
  boundary).

``--time`` adds per-stage wgrad times (CUDA events, median of 10): the
Hopper kernel and ``dwconv_wgrad.cu`` in turns, cuDNN's
``convolution_backward`` and the bound, with their sums over the 18
launches of a training step; and K1 at its two main-path shapes against
its bytes bound. Imports nothing of JAX. Exits non-zero on a mismatch or
without a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# [N, H, W, C] of a frame wider than a 64-column tile
WIDE = (4, 20, 130, 64)


def check_k1(torch, dev, record, time_it):
    from chip_smoke import (CONTENT, K1_SIDE_CONTENT, N_FRAMES, S,
                            VIVIT_CONTENT, VIVIT_S, bound_ms, max_err,
                            median_ms)
    from vision_collision_detection_tpu_torch.ops.dequant_pad import (
        dequant_normalize_pad, dequant_normalize_pad_plain)

    mean, std = (0.45,) * 3, (0.225,) * 3
    g = torch.Generator().manual_seed(6)
    for n, content, side in ((N_FRAMES, CONTENT, S), (256, VIVIT_CONTENT,
                                                      VIVIT_S),
                             (64, K1_SIDE_CONTENT, S)):
        u8 = torch.randint(0, 256, (n, *content, 3), generator=g,
                           dtype=torch.uint8).to(dev)
        for out_dtype in (torch.bfloat16, torch.float32):
            got = dequant_normalize_pad(u8, side, mean, std, out_dtype)
            ref = dequant_normalize_pad_plain(u8, side, mean, std, out_dtype)
            torch.cuda.synchronize()
            record(f"K1 → {side}² {str(out_dtype)[6:]}", list(u8.shape),
                   max_err(torch, got, ref), 0.0)
        if time_it and content != K1_SIDE_CONTENT:
            ms = median_ms(torch, lambda: dequant_normalize_pad(
                u8, side, mean, std))
            b, _ = bound_ms(u8.numel() + n * side * side * 3 * 2, 0, 1.0)
            print(f"   [time] K1 {list(u8.shape)} → {side}² bf16: {ms:.4f} ms "
                  f"(bound {b:.4f} ms by bytes, {b / ms:.0%} of it)",
                  flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_wgrad_dequant: no CUDA device is available",
              file=sys.stderr)
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
    for name in ("dwconv_wgrad_hopper", "dequant_pad"):
        for line in (lib_path.parent / f"{name}.log").read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "smem")):
                print(f"[ptxas {name}] {line.strip()[:200]}", flush=True)
    print("[card]", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)

    dev = torch.device("cuda")
    time_it = "--time" in sys.argv
    rows, faults, failed = [], [], []
    record = cs.recorder(rows, failed)
    check_k1(torch, dev, record, time_it)

    g = torch.Generator().manual_seed(1)
    stages = [(cs.N_FRAMES, H, H, C) for H, C, _ in cs.STAGES]
    for shape in stages + list(cs.K2_ODD_SHAPES) + [WIDE]:
        print(f"{list(shape)}: geometry {k2.wgrad_hopper_geometry(*shape)}",
              flush=True)
        x, _, _ = cs.k2_inputs(torch, dev, g, shape)
        gy = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        stage = shape in stages
        cs.check_k2_wgrad(torch, x, gy, record, failed,
                          faults if stage else None)
        if stage:
            with cs.swapped((k2, "wgrad_route", lambda dtype, C_: "tile")):
                cs.check_k2_wgrad(torch, x, gy, record, failed)
        del x, gy
        torch.cuda.empty_cache()
    x = torch.randn(8, 56, 56, 96, generator=g).to(dev)
    cs.check_k2_wgrad(torch, x, torch.randn(8, 56, 56, 96, generator=g).to(dev),
                      record, failed)
    del x

    if time_it:
        sums = {}
        for H, C, blocks in cs.STAGES:
            shape = (cs.N_FRAMES, H, H, C)
            x, _, _ = cs.k2_inputs(torch, dev, g, shape)
            gy = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
            t, by = cs.time_k2_wgrad(torch, x, gy)
            for k, v in t.items():
                sums[k] = sums.get(k, 0.0) + v * blocks
            print(f"   [time] wgrad {list(shape)} x{blocks}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
                  + f" ms (bound by {by}); Hopper kernel at "
                  f"{98 * x.numel() / t['hopper'] / 1e9:.1f} TFLOP/s",
                  flush=True)
            del x, gy
        print("   [time] wgrad over the 18 launches: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sums.items()) + " ms", flush=True)
    print(f"FAILED: {failed}" if failed else "ALL OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
