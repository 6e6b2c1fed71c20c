#!/usr/bin/env python3
"""K4's backward kernels alone, on one NVIDIA GPU: a quick check for work
on ``ops/csrc/flash_attention_bwd*.cu`` (about a minute, build included,
where ``chip_smoke.py`` takes two).

    python3 scripts/check_flash_bwd.py [--time] [--dump DIR]

Builds the port's kernels, prints what ``ptxas`` said of the two backward
sources (registers, spills, and any note on ``wgmma``), then holds dQ,
dK/dV and the row kernel for di against their plain PyTorch versions at
bf16, head_dim 64 and lengths on the edges of the kernels' 64-, 128- and
192-row tiles, twice (the runs must be bit-equal), and on strided views.
The tolerances are ``chip_smoke.py``'s: two bf16 ulps of the largest value
and a mean under 2^-8 of the mean |value| (at length 1, where dq and dk
are 0 in exact arithmetic, 2^-20·Σ|do·v|·scale); di within 2^-20 of the
largest Σ|o·do|.

``--time`` adds per-launch times of the three kernels, ``_row_dot`` and the
backward of ``F.scaled_dot_product_attention`` at the two large shapes
(CUDA events, median of 10). ``--dump DIR`` writes the PTX and the SASS of
``flash_attention_bwd_wgmma.cu`` there: a ``WARPGROUP.DEPBAR.LE gsb0, 0x0``
after every ``HGMMA`` means ptxas has serialised the products. Imports
nothing of JAX. Exits non-zero on a mismatch or without a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = [(1, 64, 1, 64), (1, 128, 1, 64), (2, 256, 2, 64), (1, 1, 1, 64),
          (2, 63, 2, 64), (2, 65, 2, 64), (2, 127, 2, 64), (2, 129, 2, 64),
          (2, 193, 3, 64), (4, 200, 6, 64), (4, 577, 6, 64),
          (2, 1030, 2, 64), (16, 1024, 6, 64), (256, 576, 6, 64)]
TIMED_FROM_BATCH = 16


def median_ms(torch, fn, iters=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in events)[iters // 2]


def dump(build_dir, nvcc, flags, csrc, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(csrc, "flash_attention_bwd_wgmma.cu")
    ptx = [f for f in flags if f not in ("-Xptxas", "-v")]
    subprocess.run([nvcc, *ptx, "-I", csrc, "-ptx", src, "-o",
                    os.path.join(out_dir, "flash_attention_bwd_wgmma.ptx")],
                   check=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with open(os.path.join(out_dir, "flash_attention_bwd_wgmma.sass"),
              "w") as f:
        subprocess.run([cuobjdump, "-sass", os.path.join(
            build_dir, "flash_attention_bwd_wgmma.o")], stdout=f, check=True)
    print(f"[dump] PTX and SASS in {out_dir}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_flash_bwd: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vision_collision_detection_tpu_torch.ops import _build
    from vision_collision_detection_tpu_torch.ops import flash_attention as fa

    timed = "--time" in sys.argv
    t0 = time.time()
    lib_path = _build.build()
    _build.lib()
    print(f"[build] {time.time() - t0:.1f} s", flush=True)
    for logf in sorted(lib_path.parent.glob("flash_attention_bwd*.log")):
        for line in logf.read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma")):
                print(f"[ptxas {logf.stem}] {line.strip()[:200]}", flush=True)
    if "--dump" in sys.argv:
        dump(str(lib_path.parent), _build._nvcc(), _build.NVCC_FLAGS,
             str(_build.CSRC), sys.argv[sys.argv.index("--dump") + 1])
    print("[card]", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)
    bad = 0

    def held(got, ref, floor=0.0):
        d = (got.float() - ref.float()).abs()
        tol = max(float(ref.float().abs().max()) * 2 ** -6, floor)
        mean_tol = max(float(ref.float().abs().mean()) * 2 ** -8, floor)
        ok = (float(d.max()) <= tol and float(d.mean()) <= mean_tol
              and bool(torch.isfinite(got.float()).all()))
        return ok, (f"max {float(d.max()):.2e}/{tol:.2e} "
                    f"mean {float(d.mean()):.2e}/{mean_tol:.2e}")

    for shape in SHAPES:
        B, S, H, D = shape
        q, k, v, do = (torch.randn(*shape, generator=g).to(dev, torch.bfloat16)
                       for _ in range(4))
        scale = D ** -0.5
        o, lse = fa.flash_mha_fwd(q, k, v, scale)
        di = fa.flash_mha_bwd_di(o, do)
        di_tol = float((o.float() * do.float()).abs().sum(-1).max()) * 2 ** -20
        di_err = float((di - fa._row_dot(o, do)).abs().max())
        args = (q, k, v, do, lse, di, scale)
        dq = fa.flash_mha_bwd_dq(*args)
        dk, dv = fa.flash_mha_bwd_dkv(*args)
        dq2 = fa.flash_mha_bwd_dq(*args)
        dk2, dv2 = fa.flash_mha_bwd_dkv(*args)
        torch.cuda.synchronize()
        dk_ref, dv_ref = fa.flash_mha_bwd_dkv_plain(*args)
        floor = 0.0 if S > 1 else scale * 2 ** -20 * float(
            (do.float() * v.float()).abs().sum(-1).max())
        ok = di_err <= di_tol
        line = f"{shape}: di {di_err:.2e}/{di_tol:.2e}"
        for name, got, ref, fl in (
                ("dq", dq, fa.flash_mha_bwd_dq_plain(*args), floor),
                ("dk", dk, dk_ref, floor), ("dv", dv, dv_ref, 0.0)):
            good, text = held(got, ref, fl)
            ok &= good
            line += f" | {name} {text}{'' if good else ' BAD'}"
        same = all(torch.equal(a, b)
                   for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)))
        print(line, "| twice", "equal" if same else "DIFFER", flush=True)
        bad += not (ok and same)
        if timed and B >= TIMED_FROM_BATCH:
            import torch.nn.functional as F
            t_dkv = median_ms(torch, lambda: fa.flash_mha_bwd_dkv(*args))
            t_dq = median_ms(torch, lambda: fa.flash_mha_bwd_dq(*args))
            t_di = median_ms(torch, lambda: fa.flash_mha_bwd_di(o, do))
            t_rd = median_ms(torch, lambda: fa._row_dot(o, do))
            leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, scale=scale)
            t_lib = median_ms(torch, lambda: torch.autograd.grad(
                out, leaves, do.transpose(1, 2), retain_graph=True))
            flops = B * H * S * S * D
            print(f"   [time] dK/dV {t_dkv:.3f} ms "
                  f"({8 * flops / t_dkv / 1e9:.0f} TFLOP/s), dQ {t_dq:.3f} "
                  f"({6 * flops / t_dq / 1e9:.0f}), di {t_di:.3f} (_row_dot "
                  f"{t_rd:.3f}); all {t_dkv + t_dq + t_di:.3f} against "
                  f"SDPA's backward {t_lib:.3f}", flush=True)
            del leaves, out
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()

    # q, k, v as slices of one projection, do and o as transposed views
    B, S, H, D = 4, 200, 6, 64
    q, k, v = torch.randn(B, S, 3, H, D, generator=g).to(
        dev, torch.bfloat16).unbind(2)
    do = torch.randn(B, H, S, D, generator=g).to(
        dev, torch.bfloat16).permute(0, 2, 1, 3)
    fa.flash_mha.copies = 0
    o, lse = fa.flash_mha_fwd(q, k, v, D ** -0.5)
    di = fa.flash_mha_bwd_di(
        o.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3), do)
    views = (q, k, v, do)
    copies = tuple(t.contiguous() for t in views)
    got = (fa.flash_mha_bwd_dq(*views, lse, di, D ** -0.5),
           *fa.flash_mha_bwd_dkv(*views, lse, di, D ** -0.5), di)
    ref = (fa.flash_mha_bwd_dq(*copies, lse, di, D ** -0.5),
           *fa.flash_mha_bwd_dkv(*copies, lse, di, D ** -0.5),
           fa.flash_mha_bwd_di(o, copies[3]))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    print("strided views vs contiguous:", "equal" if same else "DIFFER",
          "; copies", fa.flash_mha.copies, flush=True)
    bad += (not same) + (fa.flash_mha.copies != 0)
    print("FAILED" if bad else "ALL OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
