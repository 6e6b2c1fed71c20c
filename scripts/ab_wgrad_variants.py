#!/usr/bin/env python3
"""K2 wgrad's Hopper kernel against variants of itself on one NVIDIA GPU:
what its time is made of.

    python3 scripts/ab_wgrad_variants.py

Each variant is ``ops/csrc/dwconv_wgrad_hopper.cu`` with one change made
by text substitution, built by ``nvcc`` into its own library under
``build/wgrad_variants/`` (git-ignored) and called through the same C
entry:

- ``kernel``: the source as it is;
- ``frames_x2``: items of twice the frames where whole frames are staged
  (14² and 7²), so half the items and barriers;
- ``one_load_per_row`` (a diagnostic, its result is wrong by design): each
  x row read from shared memory once, its pixels made from that value by an
  integer add, so the loop keeps its FMAs and conversions but not its
  loads. Its time is the FMA loop's.

Every variant but the diagnostic is held against ``dwconv7x7_wgrad_plain``
(1e-6 of Σ|x·g|). Times are CUDA events, median of 10, in turns (each
variant in order, then in reverse; the mean of the two), at the flagship
step's four stage shapes, with their sums over the 18 launches. ptxas's
register and spill lines are printed. Imports nothing of JAX. Exits
non-zero on a mismatch, a failed build or without a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "vision_collision_detection_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "build" / "wgrad_variants"

# (variant, [(text in the source, its replacement)])
LOAD = "          const float2 xv = bf2_to_float2(rowp[jj * PAIRS]);\n"
VARIANTS = {
    "kernel": [],
    "frames_x2": [("int F = per_frame >= 16 ? 1 : 16 / per_frame;",
                   "int F = per_frame >= 32 ? 1 : 32 / per_frame;")],
    "one_load_per_row": [
        ("#pragma unroll\n        for (int jj = 0; jj < WIN; ++jj) {\n" + LOAD,
         "        const uint32_t xrow = rowp[0];\n#pragma unroll\n"
         "        for (int jj = 0; jj < WIN; ++jj) {\n"
         "          const float2 xv = bf2_to_float2(xrow + jj);\n")],
}
DIAGNOSTIC = "one_load_per_row"


def build() -> dict:
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    OUT.mkdir(parents=True, exist_ok=True)
    source = (CSRC / "dwconv_wgrad_hopper.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer holds "
                                 f"{old.strip()[:60]!r}")
            text = text.replace(old, new)
        src = OUT / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared",
             "-I", str(CSRC), str(src), "-o", str(OUT / f"lib{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()[:150]}", flush=True)
        if proc.returncode:
            print(log, file=sys.stderr)
            raise SystemExit(f"{name}: nvcc failed")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.vcd_dwconv_wgrad_hopper.argtypes = [P, P, P, P, I, I, I, I, I, P]
        lib.vcd_dwconv_wgrad_hopper.restype = I
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_wgrad_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    libs = build()
    print("[card]", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(1)
    failed, totals = [], dict.fromkeys(VARIANTS, 0.0)
    for H, C, blocks in cs.STAGES:
        shape = (cs.N_FRAMES, H, H, C)
        x = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        gy = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        parts = max(1, -(-2 * sms // (C // 32)))
        partial = torch.empty(parts, 49, C, device=dev)
        ref = k2.dwconv7x7_wgrad_plain(x, gy)
        scale = k2.dwconv7x7_wgrad_plain(x.abs(), gy.abs()).clamp_min(1e-30)
        runs = {}
        for name, lib in libs.items():
            dw = torch.empty(49, C, device=dev)

            def run(lib=lib, dw=dw):
                err = lib.vcd_dwconv_wgrad_hopper(
                    x.data_ptr(), gy.data_ptr(), partial.data_ptr(),
                    dw.data_ptr(), *shape, parts, stream)
                if err:
                    raise SystemExit(f"launch failed with CUDA error {err}")

            run()
            torch.cuda.synchronize()
            rel = float(((dw - ref).abs() / scale).max())
            if name != DIAGNOSTIC and not rel <= cs.WGRAD_TOL:
                failed.append(f"{name} at {list(shape)}: {rel:.2e}")
            runs[name] = run
        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            times[name].append(cs.median_ms(torch, runs[name]))
        ms = {name: statistics.mean(v) for name, v in times.items()}
        for name, v in ms.items():
            totals[name] += v * blocks
        print(f"[time] {list(shape)} x{blocks}: " + ", ".join(
            f"{n} {v:.4f}" for n, v in ms.items()) + " ms", flush=True)
        del x, gy, partial
    print("[time] over the 18 launches: " + ", ".join(
        f"{n} {v:.3f}" for n, v in totals.items()) + " ms", flush=True)
    print(f"FAILED: {failed}" if failed else "ALL OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
