#!/usr/bin/env python3
"""K4's forward kernel alone, on one NVIDIA GPU: a quick check for work on
``ops/csrc/flash_attention_fwd_wgmma.cu`` (about a minute, build included,
where ``chip_smoke.py`` takes several).

    python3 scripts/check_flash_fwd.py [--time]

Builds the port's kernels, prints what ``ptxas`` said of the forward
sources (registers, spills, and any note on ``wgmma``), then holds the
forward (o and the log-sum-exp) against ``flash_mha_plain`` at bf16,
head_dim 64 and lengths on the edges of the kernel's 64-key tiles, its
two-tile steps and its 192-query items, and on strided views (no copy).
The tolerances are ``chip_smoke.py``'s ``flash_tols``: two bf16 ulps of
the largest value and a mean under 2^-8 of the mean |value|; the
log-sum-exp within 1e-4.

``--time`` adds per-launch times (CUDA events, median of 10) at the four
shapes of ``PERF.md``'s per-shape table: the Hopper kernel, the
``mma.sync`` kernel of ``flash_attention.cu`` on the same inputs (the route
forced), ``F.scaled_dot_product_attention``, and TFLOP/s. Imports nothing
of JAX. Exits non-zero on a mismatch or without a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = [(1, 1, 1, 64), (2, 63, 2, 64), (2, 64, 2, 64), (2, 65, 2, 64),
          (2, 127, 2, 64), (2, 128, 2, 64), (2, 129, 2, 64),
          (2, 191, 3, 64), (2, 193, 3, 64), (4, 200, 6, 64),
          (4, 577, 6, 64), (2, 1030, 2, 64), (8, 576, 12, 64),
          (16, 1024, 6, 64), (256, 576, 6, 64)]
TIMED = [(256, 576, 6, 64), (64, 576, 6, 64), (16, 1024, 6, 64),
         (8, 576, 12, 64)]


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_flash_fwd: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vision_collision_detection_tpu_torch.ops import _build
    from vision_collision_detection_tpu_torch.ops import flash_attention as fa

    t0 = time.time()
    lib_path = _build.build()
    _build.lib()
    print(f"[build] {time.time() - t0:.1f} s", flush=True)
    for logf in sorted(lib_path.parent.glob("flash_attention*.log")):
        for line in logf.read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma")):
                print(f"[ptxas {logf.stem}] {line.strip()[:200]}", flush=True)
    print("[card]", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    bad = 0
    for shape in SHAPES:
        B, S, H, D = shape
        q, k, v = (torch.randn(*shape, generator=g).to(dev, torch.bfloat16)
                   for _ in range(3))
        scale = D ** -0.5
        fa.flash_mha.wgmma_launches = 0
        o, lse = fa.flash_mha_fwd(q, k, v, scale)
        with torch.no_grad():
            o2 = fa.flash_mha(q, k, v, scale)
        o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, scale)
        torch.cuda.synchronize()
        d = (o.float() - o_ref.float()).abs()
        tol = float(o_ref.float().abs().max()) * 2 ** -6
        mean_tol = float(o_ref.float().abs().mean()) * 2 ** -8
        lse_err = float((lse - lse_ref).abs().max())
        ok = (float(d.max()) <= tol and float(d.mean()) <= mean_tol
              and lse_err <= 1e-4 and torch.equal(o, o2)
              and fa.flash_mha.wgmma_launches == 2)
        print(f"{shape}: o max {float(d.max()):.2e}/{tol:.2e} mean "
              f"{float(d.mean()):.2e}/{mean_tol:.2e} | lse {lse_err:.2e}/1e-4"
              f" | without lse {'equal' if torch.equal(o, o2) else 'DIFFERS'}"
              f" | Hopper launches {fa.flash_mha.wgmma_launches}"
              f"{'' if ok else ' BAD'}", flush=True)
        bad += not ok
        del q, k, v, o, o2, o_ref, lse, lse_ref
        torch.cuda.empty_cache()

    # q, k, v as slices of one fused projection: read through their strides
    B, S, H, D = 4, 200, 6, 64
    q, k, v = torch.randn(B, S, 3, H, D, generator=g).to(
        dev, torch.bfloat16).unbind(2)
    fa.flash_mha.copies = 0
    o, lse = fa.flash_mha_fwd(q, k, v, D ** -0.5)
    oc, lsec = fa.flash_mha_fwd(*(t.contiguous() for t in (q, k, v)),
                                D ** -0.5)
    torch.cuda.synchronize()
    same = torch.equal(o, oc) and torch.equal(lse, lsec)
    print("strided views vs contiguous:", "equal" if same else "DIFFER",
          "; copies", fa.flash_mha.copies, flush=True)
    bad += (not same) + (fa.flash_mha.copies != 0)

    if "--time" in sys.argv:
        import torch.nn.functional as F
        for shape in TIMED:
            B, S, H, D = shape
            q, k, v = (torch.randn(*shape, generator=g).to(dev, torch.bfloat16)
                       for _ in range(3))
            scale = D ** -0.5
            with torch.no_grad():
                t_new = median_ms(torch, lambda: fa.flash_mha(q, k, v, scale))
                route = fa.route
                fa.route = lambda dtype, head_dim: "mma"
                try:
                    t_old = median_ms(torch, lambda: fa.flash_mha(q, k, v,
                                                                  scale))
                finally:
                    fa.route = route
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                t_lib = median_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, scale=scale))
            flops = 4 * B * H * S * S * D
            print(f"   [time] {shape}: Hopper {t_new:.4f} ms "
                  f"({flops / t_new / 1e9:.0f} TFLOP/s), mma.sync "
                  f"{t_old:.4f} ({flops / t_old / 1e9:.0f}), SDPA "
                  f"{t_lib:.4f} ({flops / t_lib / 1e9:.0f})", flush=True)
            del q, k, v
    print("FAILED" if bad else "ALL OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
