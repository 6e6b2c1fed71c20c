#!/usr/bin/env python3
"""K3's split kernel (``ops/csrc/convnext_mlp_wide.cu``) against variants
of itself on one NVIDIA GPU: what its time is made of.

    python3 scripts/ab_convnext_mlp_wide_variants.py [--float32]

Each variant is the source with one change made by text substitution,
built by ``nvcc`` into its own library under ``build/wide_variants/``
(git-ignored) and called through the same C entry:

- ``kernel``: the source as it is (clusters of two blocks sharing each B
  tile by TMA multicast; each GEMM's tile width by ``pick_tile_n``);
- ``tile128``, ``tile256``: both GEMMs at that tile width;
- ``cluster1``: clusters of one, each block loading its whole B tile;
- ``mainloop_only`` and ``tile256_mainloop_only`` (diagnostics, their
  results are wrong by design): the GEMMs without their epilogues, so
  their time is the products' and the loads';
- ``erff``: GELU's erf form by ``erff`` (``convnext_mlp_common.cuh``)
  instead of the kernel's branch-free approximation;
- ``no_gelu`` (a diagnostic): GEMM 1 writes h_pre where h belongs, so
  the time of GELU is the difference;
- ``f32_round128`` (with ``--float32`` only, beside ``kernel``): GEMM 2's
  float32 epilogue staging 128 columns a round in four tiles, the ring one
  stage shorter, where the kernel stages 64 in two.

``--float32`` runs ``kernel`` and ``f32_round128`` on float32 x, y and out
(the entry's dtype code 1), the two choices of the float32 epilogue.

Every variant but the diagnostics is held against
``convnext_mlp_train_plain`` by ``chip_smoke.py``'s rule (2^-6 of the
largest value, a mean under 2^-12 of the mean), eval and train. Times are
CUDA events, median of 10, each call queued behind a device-side wait, in
turns (each variant in order, then in reverse; the mean of the two), at
[9800, 1024] and [9800, 1536] (ConvNeXt base's and large's last stage at
B=8 · 25 frames of 224²): each GEMM alone and the whole eval call, with
both GELU forms. ptxas's register
and spill lines are printed. Imports nothing of JAX. Exits non-zero on a
mismatch, a failed build or without a CUDA device.
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
OUT = ROOT / "build" / "wide_variants"

ONE = ("constexpr int CLUSTER = 2;", "constexpr int CLUSTER = 1;")
RULE = "  return narrow < wide ? 128 : 256;"
TILE256 = (RULE, "  return 256;")
NO_EPILOGUE = ("      epilogue<MODE, BN>(acc, ep, st,",
               "      if (false) epilogue<MODE, BN>(acc, ep, st,")
# (variant, [(text in the source, its replacement)])
VARIANTS = {
    "kernel": [],
    "tile128": [(RULE, "  return 128;")],
    "tile256": [TILE256],
    "cluster1": [ONE],
    "mainloop_only": [NO_EPILOGUE],
    "tile256_mainloop_only": [TILE256, NO_EPILOGUE],
    "erff": [("return gelu_erf(v);", "return gelu<false>(v);")],
    "no_gelu": [("gelu_fast<APPROX>(hf.x),\n"
                 "                                     gelu_fast<APPROX>(hf.y));",
                 "hf.x, hf.y);")],
    "f32_round128": [("constexpr int F32_ROUND = 64;",
                      "constexpr int F32_ROUND = 128;")],
}
F32_VARIANTS = ("kernel", "f32_round128")
DIAGNOSTICS = ("mainloop_only", "tile256_mainloop_only", "no_gelu")
WIDTHS = (1024, 1536)
M = 9800


def build(names) -> dict:
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    OUT.mkdir(parents=True, exist_ok=True)
    source = (CSRC / "convnext_mlp_wide.cu").read_text()
    procs = {}
    for name in names:
        edits = VARIANTS[name]
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
             "-I", str(CSRC), str(src), "-o", str(OUT / f"lib{name}.so"),
             "-ldl"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                print(f"[ptxas {name}] {line.strip()[:150]}", flush=True)
        if proc.returncode:
            print(log, file=sys.stderr)
            raise SystemExit(f"{name}: nvcc failed")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.vcd_convnext_mlp_wide.argtypes = [P] * 14 + [I] * 5 + [P]
        lib.vcd_convnext_mlp_wide.restype = I
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_convnext_mlp_wide_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3

    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = "--float32" in sys.argv
    dtype = torch.float32 if f32 else torch.bfloat16
    libs = build(F32_VARIANTS if f32 else
                 [n for n in VARIANTS if n != "f32_round128"])
    print("[card]", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(23)
    failed = []

    def held(got, ref):
        err = float((got.float() - ref.float()).abs().max())
        mean = float((got.float() - ref.float()).abs().mean())
        return (err <= float(ref.float().abs().max()) * 2 ** -6 and
                mean <= float(ref.float().abs().mean()) * 2 ** -12)

    for C in WIDTHS:
        xs = torch.randn(M, C, generator=g, device=dev).to(dtype)
        y = torch.randn(M, C, generator=g, device=dev).to(dtype)
        p = cs.k3_params(torch, C, g, dev)
        ptrs, _keep, _, _ = k3._kernel_operands(xs, y, **p)
        bf = dict(dtype=torch.bfloat16, device=dev)
        out = torch.empty_like(xs)
        t, m = torch.empty(M, C, **bf), torch.empty(M, C, **bf)
        h, h_pre = torch.empty(M, 4 * C, **bf), torch.empty(M, 4 * C, **bf)

        def call(lib, stages, approximate, train=False):
            err = lib.vcd_convnext_mlp_wide(
                *ptrs, out.data_ptr(), t.data_ptr(), h.data_ptr(),
                h_pre.data_ptr() if train else None,
                m.data_ptr() if train else None, M, C, int(approximate),
                int(f32), stages, stream)
            if err:
                raise SystemExit(f"launch failed with CUDA error {err}")

        for name, lib in libs.items():
            if name in DIAGNOSTICS:
                continue
            for approximate in (True, False):
                ref = k3.convnext_mlp_train_plain(xs, y,
                                                  approximate=approximate, **p)
                call(lib, k3.WIDE_ALL, approximate)
                torch.cuda.synchronize()
                got_eval = out.clone()
                call(lib, k3.WIDE_ALL, approximate, train=True)
                torch.cuda.synchronize()
                ok = (held(out, ref[0]) and held(t, ref[1])
                      and held(h_pre, ref[2]) and held(m, ref[3])
                      and torch.equal(out, got_eval))
                print(f"[check] {name} C={C} approximate={approximate}: "
                      f"{'ok' if ok else 'FAILED'}", flush=True)
                if not ok:
                    failed.append(f"{name} C={C} approximate={approximate}")
        cases = {
            "up tanh": (k3.WIDE_UP, True), "up erf": (k3.WIDE_UP, False),
            "down": (k3.WIDE_DOWN, True),
            "eval tanh": (k3.WIDE_ALL, True),
            "eval erf": (k3.WIDE_ALL, False)}
        flops = {"up": 8 * M * C * C, "down": 8 * M * C * C,
                 "eval": 16 * M * C * C}
        for case, (stages, approximate) in cases.items():
            times = {name: [] for name in libs}
            for name in list(libs) + list(libs)[::-1]:
                times[name].append(cs.median_ms(torch, lambda: call(
                    libs[name], stages, approximate)))
            ms = {name: statistics.mean(v) for name, v in times.items()}
            f = flops[case.split()[0]]
            print(f"[time] C={C} {case}: " + ", ".join(
                f"{n} {v:.4f} ms ({f / v / 1e9:.0f} TFLOP/s)"
                for n, v in ms.items()), flush=True)
        del xs, y, p, ptrs, _keep, out, t, m, h, h_pre
        torch.cuda.empty_cache()
    print(f"FAILED: {failed}" if failed else "ALL OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
