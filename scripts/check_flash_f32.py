#!/usr/bin/env python3
"""K4's float32 kernels alone, on one NVIDIA GPU: a quick check for work on
``ops/csrc/flash_attention_fwd_f32.cu`` and ``flash_attention_bwd_f32.cu``
(float32 attention as split bf16 products on the tensor cores).

    python3 scripts/check_flash_f32.py [--time]

Builds the port's kernels, prints what ``ptxas`` said of the float32
sources (registers, spills, and any note on ``wgmma``), then runs
``chip_smoke.py``'s K4 checks (``compare_flash_kernels``) at its float32
shapes (the scaled configuration's [256, 576, 6, 64] and the lengths on
the kernels' tile edges), head_dim 16 in float32 and one bf16 shape: o and
the log-sum-exp, di, dq, dk, dv against the plain versions with
``chip_smoke.py``'s rules (float32: 2^-14 of the largest value, on the
largest and the mean error), the backward bit-equal over two runs, each
call on its route's kernel, strided views read without a copy, and the
faults (the split fault too) landing outside. ``--time`` adds
``chip_smoke.py``'s ``time_flash_routes``: the float32 kernels per launch,
the split pass alone, the CUDA-core kernels on the same inputs, the plain
versions and ``F.scaled_dot_product_attention`` in float32, and head_dim
16 at vivit_tiny's shape. Imports nothing of JAX. Exits non-zero on a
mismatch or without a CUDA device.
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
        print("check_flash_f32: no CUDA device is available", file=sys.stderr)
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
    for logf in sorted(lib_path.parent.glob("flash_attention_*f32.log")):
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
    shapes = chip_smoke.FLASH_F32_SHAPES + (
        (2, 200, 4, 16, "float32"), (4, 200, 6, 64, "bfloat16"))
    out = chip_smoke.compare_flash_kernels(torch, dev, shapes=shapes)
    seen = sum(f["seen"] for f in out["faults"])
    print(f"[check] {len(out['rows'])} comparisons, {seen} of "
          f"{len(out['faults'])} faults seen", flush=True)
    if "--time" in sys.argv:
        chip_smoke.time_flash_routes(torch, dev, out["inputs"])
    print("ALL OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
