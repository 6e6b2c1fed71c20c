#!/usr/bin/env python3
"""K4's head_dim-16 kernels alone, on one NVIDIA GPU: a quick check for work
on ``ops/csrc/flash_d16.cuh`` (vivit_tiny's attention, bf16 and float32, on
Hopper's wgmma and TMA).

    python3 scripts/check_flash_d16.py [--time]

Builds the port's kernels, prints what ``ptxas`` said of K4's sources
(registers, spills, and any note on ``wgmma``), then runs
``chip_smoke.py``'s K4 checks (``compare_flash_kernels``) at its head_dim-16
shapes (vivit_tiny's [256, 256, 4, 16] and the lengths on the kernels' tile
edges, bf16 and float32) and one head_dim-64 shape of each dtype: o and the
log-sum-exp, di, dq, dk, dv against the plain versions with
``chip_smoke.py``'s rules, the backward bit-equal over two runs, each call on
its route's kernel, strided views read without a copy, and the faults (the
split fault too) landing outside. ``--time`` adds ``chip_smoke.py``'s
``time_flash_routes`` at vivit_tiny's shape: each kernel per launch beside
the kernel it replaced (``mma_sync_ms``, ``cuda_core_ms``), the split pass,
the plain versions, ``F.scaled_dot_product_attention``, the bound and the
exponentials' floor. Imports nothing of JAX. Exits non-zero on a mismatch
or without a CUDA device.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_flash_d16: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from vision_collision_detection_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    lib_path = _build.build()
    _build.lib()
    print(f"[build] {time.time() - t0:.1f} s", flush=True)
    for logf in sorted(lib_path.parent.glob("flash_attention_*.log")):
        function = None
        for line in logf.read_text().splitlines():
            if "Function properties for" in line:
                function = line.split("Function properties for")[-1].strip()
            if any(w in line for w in ("registers", "spill", "wgmma")):
                print(f"[ptxas {logf.stem}] {function}: {line.strip()[:200]}",
                      flush=True)
            spill = re.search(r"(\d+) bytes spill stores", line)
            if spill and spill.group(1) != "0":
                print(f"[ptxas {logf.stem}] spills in {function}", flush=True)
    print("[card]", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)

    dev = torch.device("cuda")
    shapes = chip_smoke.FLASH_D16_SHAPES + (
        (4, 200, 6, 64, "bfloat16"), (4, 577, 6, 64, "float32"))
    out = chip_smoke.compare_flash_kernels(torch, dev, shapes=shapes)
    seen = sum(f["seen"] for f in out["faults"])
    print(f"[check] {len(out['rows'])} comparisons, {seen} of "
          f"{len(out['faults'])} faults seen", flush=True)
    if "--time" in sys.argv:
        chip_smoke.time_flash_routes(torch, dev, out["inputs"],
                                     shapes=chip_smoke.FLASH_D16)
    print("ALL OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
