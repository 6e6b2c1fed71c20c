#!/usr/bin/env python3
"""K3 alone, on one NVIDIA GPU: a quick check for work on
``ops/csrc/convnext_mlp_wgmma.cu`` (a minute or two, build included, where
``chip_smoke.py`` takes several).

    python3 scripts/check_convnext_mlp.py [--time]

Builds the port's kernels, prints what ``ptxas`` said of K3's sources
(registers, spills, and any note on ``wgmma``), then holds the eval and
train variants against their plain PyTorch versions with both GELU forms,
bf16 activations, at every width of ``WGMMA_DIMS`` at 100 and 2,000 rows
(less than one block's rows, and no multiple of them) and at the flagship
forward's four stage shapes, with ``chip_smoke.py``'s parameters and
rule: two bf16 ulps of the largest value and a mean under 2^-12 of the
mean |value|; the train variant's out bit-equal to the eval variant's,
its t, h_pre and m by the same rule. The faults of ``chip_smoke.py``
(γ off by 1%, b2 dropped, the other GELU form) must land outside at the
stage shapes.

``--time`` adds per-stage times (CUDA events, median of 10) at the stage
shapes: the Hopper kernel and the ``mma.sync`` kernel of
``convnext_mlp.cu`` on the same inputs (the route forced), both variants,
beside the stock chain LN → ``F.linear`` → GELU → ``F.linear`` → γ,
residual, and each variant's bound. Imports nothing of JAX. Exits
non-zero on a mismatch or without a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_convnext_mlp: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from vision_collision_detection_tpu_torch.ops import _build
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    lib_path = _build.build()
    _build.lib()
    print(f"[build] {time.time() - t0:.1f} s", flush=True)
    for logf in sorted(lib_path.parent.glob("convnext_mlp*.log")):
        for line in logf.read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma")):
                print(f"[ptxas {logf.stem}] {line.strip()[:200]}", flush=True)
    print("[card]", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    bad = 0

    def held(got, ref):
        err = float((got.float() - ref.float()).abs().max())
        mean = float((got.float() - ref.float()).abs().mean())
        tol = float(ref.float().abs().max()) * 2 ** -6
        mean_tol = float(ref.float().abs().mean()) * 2 ** -12
        ok = err <= tol and mean <= mean_tol
        return ok, f"max {err:.2e}/{tol:.2e} mean {mean:.2e}/{mean_tol:.2e}"

    stages = {C: cs.N_FRAMES * H * H for H, C, _ in cs.STAGES}
    cases = [(C, M) for C in k3.WGMMA_DIMS for M in (100, 2000)]
    cases += list(stages.items())
    timed_inputs = {}
    for C, M in cases:
        x = torch.randn(M, C, generator=g).to(dev, torch.bfloat16)
        y = torch.randn(M, C, generator=g).to(dev, torch.bfloat16)
        p = cs.k3_params(torch, C, g, dev)
        for approximate in (True, False):
            k3.convnext_mlp.wgmma_launches = 0
            k3.convnext_mlp_train.wgmma_launches = 0
            with torch.no_grad():
                out = k3.convnext_mlp(x, y, approximate=approximate, **p)
            got = k3.convnext_mlp_train(x, y, approximate=approximate, **p)
            ref = k3.convnext_mlp_train_plain(x, y, approximate=approximate,
                                              **p)
            torch.cuda.synchronize()
            ok_o, text = held(out, ref[0])
            line = f"C={C} M={M} approximate={approximate}: out {text}"
            ok = ok_o and torch.equal(out, got[0])
            line += f" | train out {'equal' if torch.equal(out, got[0]) else 'DIFFERS'}"
            for name, a, b in zip(("t", "h_pre", "m"), got[1:], ref[1:]):
                good, text = held(a, b)
                ok &= good
                line += f" | {name} {text}{'' if good else ' BAD'}"
            routed = (k3.convnext_mlp.wgmma_launches == 1
                      and k3.convnext_mlp_train.wgmma_launches == 1)
            ok &= routed
            print(line + ("" if routed else " | NOT ROUTED") +
                  ("" if ok else " BAD"), flush=True)
            bad += not ok
            if stages.get(C) == M and not approximate:
                for fault, change in cs.K3_FAULTS.items():
                    fp, fap = change(p, approximate)
                    wrong = k3.convnext_mlp_plain(x, y, approximate=fap, **fp)
                    seen = not held(out, wrong)[0]
                    print(f"   fault {fault}: {'seen' if seen else 'NOT seen'}",
                          flush=True)
                    bad += not seen
            del out, got, ref
        if stages.get(C) == M:
            timed_inputs[C] = (x, y, p)
        torch.cuda.empty_cache()

    if "--time" in sys.argv:
        import torch.nn.functional as F
        sums = {}
        for C, (x, y, p) in timed_inputs.items():
            M = x.shape[0]
            w1t, w2t = k3.kernel_weights(p["w1"], p["w2"], "wgmma")
            b1, b2 = p["b1"].to(torch.bfloat16), p["b2"].to(torch.bfloat16)
            gam = p["gamma"].to(torch.bfloat16)

            def stock():
                t = F.layer_norm(y.float(), (C,), p["ln_w"], p["ln_b"],
                                 1e-6).to(torch.bfloat16)
                h = F.gelu(F.linear(t, w1t, b1), approximate="tanh")
                return x + F.linear(h, w2t, b2) * gam

            def run(train):
                fn = k3.convnext_mlp_train if train else k3.convnext_mlp
                with torch.no_grad():
                    return cs.median_ms(torch, lambda: fn(
                        x, y, approximate=True, **p))

            t = {"eval": run(False), "train": run(True)}
            route = k3.route
            k3.route = lambda dtype, C_: "mma"
            try:
                t["eval mma.sync"] = run(False)
                t["train mma.sync"] = run(True)
            finally:
                k3.route = route
            t["stock chain"] = cs.median_ms(torch, stock)
            flops = 16 * M * C * C
            t["bound eval"] = cs.bound_ms(3 * M * C * 2 + 8 * C * C * 2,
                                          flops, cs.BF16_FLOPS)[0]
            t["bound train"] = cs.bound_ms(18 * M * C + 8 * C * C * 2,
                                           flops, cs.BF16_FLOPS)[0]
            blocks = dict((c, b) for _, c, b in cs.STAGES)[C]
            for k, v in t.items():
                sums[k] = sums.get(k, 0.0) + v * blocks
            print(f"   [time] C={C} M={M} x{blocks}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in t.items())
                + f" ms; eval {flops / t['eval'] / 1e9:.0f} TFLOP/s",
                flush=True)
        print("   [time] over the 18 launches: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sums.items()) + " ms", flush=True)
    print("FAILED" if bad else "ALL OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
