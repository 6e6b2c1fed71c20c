#!/usr/bin/env python3
"""K4's head_dim-16 kernels (``ops/csrc/flash_d16.cuh``) against variants
of their own source on one NVIDIA GPU: what their time is made of.

    python3 scripts/ab_flash_d16_variants.py [VARIANT ...]

Each variant is the source with one change made by text substitution,
its four K4 sources built by ``nvcc`` into a library of its own under
``build/flash_d16_variants/`` (git-ignored) and called through the port's
launchers (the kernel library swapped for the variant's):

- ``kernel``: the source as it is (the forward: four consumer warpgroups,
  items of 256 queries, key tiles of 64; the backward: bf16 dQ four, the
  others two);
- ``chain_max``: the row maximum as one chain of dependent steps, not a
  tree;
- ``fwd_nwg2_kt128``: the forward with two consumer warpgroups and key
  tiles of 128;
- ``bwd_nwg2``, ``bwd_nwg4``: every backward kernel with two (items of
  128 rows) or four (256; dK/dV and float32 dQ then spill) consumer
  warpgroups;
- ``no_exp`` and ``no_pv`` (diagnostics, their results are wrong by
  design): the exponentials replaced by their argument, and the bf16
  forward without its p·v products.

Earlier variants measured on the H100 (``PERF.md``, PR 21): two consumer
warpgroups with key tiles of 128, two a step in bf16 (the first design);
key tiles of 64 two a step; three warpgroups (items of 192 rows; they
failed the bit-equality checks); four warpgroups with tiles of 128 (they
spilled the logits and failed them too).

Every variant but the diagnostics is held against the plain versions by
``chip_smoke.py``'s rule (``compare_flash_kernels`` at vivit_tiny's shape
and the tile edges, bf16 and float32). Times are CUDA events, median of
10, each call queued behind a device-side wait, in turns (each variant in
order, then in reverse; the mean of the two), per launch at
[256, 256, 4, 16] (vivit_tiny), bf16 and float32 (the float32 kernels on
split copies made beforehand), beside the exponentials' floor. ptxas's
register and spill lines are printed. Imports nothing of JAX. Exits
non-zero on a mismatch, a failed build or without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "vision_collision_detection_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "build" / "flash_d16_variants"
SOURCES = ("flash_attention_fwd_wgmma.cu", "flash_attention_bwd_wgmma.cu",
           "flash_attention_fwd_f32.cu", "flash_attention_bwd_f32.cu")

FWD = "constexpr int FWD_NWG = 4, FWD_KT = 64;"
BWD = "constexpr int BWD_NWG = DKV || F32 ? 2 : 4;"


TREE_MAX = """    float m2[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      m2[nt] = fmaxf(s[nt][2 * half], s[nt][2 * half + 1]);
#pragma unroll
    for (int w = NT / 2; w > 0; w /= 2)
#pragma unroll
      for (int nt = 0; nt < w; ++nt) m2[nt] = fmaxf(m2[nt], m2[nt + w]);
    float mx = m2[0];
"""
CHAIN_MAX = """    float mx = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mx = fmaxf(mx, fmaxf(s[nt][2 * half], s[nt][2 * half + 1]));
"""

# (variant, [(file, text in it, its replacement)])
VARIANTS = {
    "kernel": [],
    "chain_max": [("flash_d16.cuh", TREE_MAX, CHAIN_MAX)],
    "fwd_nwg2_kt128": [("flash_d16.cuh", FWD,
                        "constexpr int FWD_NWG = 2, FWD_KT = 128;")],
    "bwd_nwg2": [("flash_d16.cuh", BWD, "constexpr int BWD_NWG = 2;")],
    "bwd_nwg4": [("flash_d16.cuh", BWD, "constexpr int BWD_NWG = 4;")],
    "no_exp": [("hopper.cuh",
                '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "  y = x;")],
    "no_pv": [("flash_d16.cuh", "    ab16(o, p, stg.v[0]);\n", "\n")],
}
DIAGNOSTICS = ("no_exp", "no_pv")


def build(names) -> dict:
    from vision_collision_detection_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        src = OUT / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(CSRC, src)
        for fname, old, new in VARIANTS[name]:
            path = src / fname
            text = path.read_text()
            if old not in text:
                raise SystemExit(f"{name}: {fname} no longer holds "
                                 f"{old.strip()[:60]!r}")
            path.write_text(text.replace(old, new))
        procs[name] = [(f, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(src), "-c", str(src / f),
             "-o", str(src / (f + ".o"))], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)) for f in SOURCES + (
                "errors.cu",)]
    libs = {}
    for name, jobs in procs.items():
        src = OUT / name
        for f, proc in jobs:
            log = proc.communicate()[0]
            function = None
            for line in log.splitlines():
                if "Function properties for" in line:
                    function = line.split("Function properties for")[-1]
                if ("d16" in (function or "") and any(
                        w in line for w in ("registers", "spill", "wgmma"))):
                    print(f"[ptxas {name}] {function.strip()[:60]}: "
                          f"{line.strip()[:120]}", flush=True)
            if proc.returncode:
                print(log[-6000:], file=sys.stderr)
                raise SystemExit(f"{name}: nvcc failed on {f}")
        lib_path = src / "libvariant.so"
        subprocess.run([nvcc, "-shared", "-o", str(lib_path),
                        *[str(src / (f + ".o")) for f in SOURCES + (
                            "errors.cu",)], *_build.LINK_FLAGS], check=True)
        lib = ctypes.CDLL(str(lib_path))
        for entry, argtypes in _build._SIGNATURES.items():
            if entry.startswith("vcd_flash") and entry != "vcd_flash_bwd_di":
                fn = getattr(lib, entry, None)
                if fn is not None:
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
        lib.vcd_error_string.argtypes = [ctypes.c_int]
        lib.vcd_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


class VariantLib:
    """The port's kernel library with K4's head_dim-16 entries (and the
    split pass) taken from a variant's."""

    def __init__(self, base, variant):
        self.base, self.variant = base, variant

    def __getattr__(self, name):
        if name.startswith("vcd_flash") and name != "vcd_flash_bwd_di":
            return getattr(self.variant, name)
        return getattr(self.base, name)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_flash_d16_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vision_collision_detection_tpu_torch.ops import _build
    from vision_collision_detection_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    names = [n for n in sys.argv[1:] if n in VARIANTS] or list(VARIANTS)
    if "kernel" not in names:
        names.insert(0, "kernel")
    base = _build.lib()
    libs = build(names)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print("[card]", card, flush=True)
    dev = torch.device("cuda")
    failed = []
    check_shapes = [s for s in cs.FLASH_D16_SHAPES if s[1] in (256, 65, 129,
                                                              257, 4)]
    for name, lib in libs.items():
        if name in DIAGNOSTICS:
            continue
        _build._lib = VariantLib(base, lib)
        try:
            out = cs.compare_flash_kernels(torch, dev, shapes=check_shapes)
            print(f"[check] {name}: {len(out['rows'])} comparisons ok",
                  flush=True)
        except SystemExit as e:
            failed.append(name)
            print(f"[check] {name}: FAILED {str(e)[:300]}", flush=True)
        finally:
            _build._lib = base
    g = torch.Generator().manual_seed(22)
    record = {"card": card, "ms": {}}
    for shape in cs.FLASH_D16:
        B, S, H, D, dtype = shape
        q, k, v, do = cs.flash_inputs(torch, shape, dev, g)
        scale = D ** -0.5
        o, lse = fa.flash_mha_fwd(q, k, v, scale)
        di = fa.flash_mha_bwd_di(o, do)
        f32 = dtype == "float32"
        fwd_split = fa.flash_mha_split(q, k, v) if f32 else None
        bwd_split = fa.flash_mha_split(q, k, v, do) if f32 else None
        args = (q, k, v, do, lse, di, scale)
        calls = {
            "fwd": lambda: fa._launch_fwd(q, k, v, scale, need_lse=False,
                                          split=fwd_split),
            "dkv": lambda: fa._launch_bwd_dkv(*args, split=bwd_split),
            "dq": lambda: fa._launch_bwd_dq(*args, split=bwd_split)}
        floor = cs.exp_floor_ms(S * S * B * H)
        for kind, call in calls.items():
            times = {n: [] for n in libs}
            for n in list(libs) + list(libs)[::-1]:
                _build._lib = VariantLib(base, libs[n])
                try:
                    times[n].append(cs.median_ms(torch, call))
                finally:
                    _build._lib = base
            ms = {n: statistics.mean(t) for n, t in times.items()}
            record["ms"][f"{dtype} {kind}"] = ms
            print(f"[time] {dtype} {kind} {list(shape)} per launch (exp "
                  f"floor {floor:.4f} ms): " + ", ".join(
                      f"{n} {t:.4f}" for n, t in ms.items()), flush=True)
        del q, k, v, do, o, lse, di, fwd_split, bwd_split
        torch.cuda.empty_cache()
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "ab_flash_d16_variants.json", "w") as f:
        json.dump(record, f, indent=1)
    if failed:
        print(f"ab_flash_d16_variants: {failed} disagree with the plain "
              f"versions", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
