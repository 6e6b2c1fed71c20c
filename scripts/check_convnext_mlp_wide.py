#!/usr/bin/env python3
"""K3's split wgmma kernel (``ops/csrc/convnext_mlp_wide.cu``) alone, on
one NVIDIA GPU: a quick check for work on it (a minute or two, build
included).

    python3 scripts/check_convnext_mlp_wide.py [--time] [--float32]

Builds the port's kernels, prints what ``ptxas`` said of the source
(registers, spills, and any note on ``wgmma``), then, at C = 768, 1024 and
1536 and M = 100, 2,000 and 9,800 rows, bf16, both GELU forms: the eval and
train variants against ``convnext_mlp_train_plain`` with ``chip_smoke.py``'s
parameters and rule (two bf16 ulps of the largest value, a mean under
2^-12 of the mean |value|), the train variant's out bit-equal to the eval
variant's, a second eval call bit-equal to the first, and each of the
three stages (``ln_stage``, ``up_stage``, ``down_stage``) against its own
plain version on the plain version's inputs, by the same rule (m against
the plain m rounded to bf16, as the kernel saves it). At 1024 and
1536 the calls go through ``convnext_mlp`` and must take the wide route;
at 768 (the route's ``"wgmma"``) the entry is called directly.

``--time`` adds, at M = 9,800 (ConvNeXt's last stage at B=8 · 25 frames
of 224²): the whole eval and train calls (CUDA events, median of 10,
each queued behind a device-side wait; W1 and W2 as a block hands them
over, transposed views of nn.Linear's float32 storage), each of the
three stages alone,
the ``mma.sync`` kernel of ``convnext_mlp.cu`` on the same inputs (the
route forced), the Hopper kernel of ``convnext_mlp_wgmma.cu`` at 768, the
stock chain LN → ``F.linear`` → GELU → ``F.linear`` → γ, residual, the
plain version, and the bound. Imports nothing of JAX. Exits non-zero on a
mismatch or without a CUDA device.

``--float32`` does the same on float32 x and y (out float32; t, h, h_pre
and m bf16 as in bf16), the split kernel's float32 route, and its
``--time`` takes ``chip_smoke.py``'s ``time_k3_wide_f32`` at 1024 and 1536
(eval and train in turns with ``convnext_mlp.cu`` on the same inputs, the
route forced, beside the stock float32 chain, the plain versions and the
bounds) with the three stages alone.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = (768, 1024, 1536)
ROWS = (100, 2000, 9800)


def wide_call(torch, k3, xs, y, p, approximate, train):
    """The wide entry on (xs, y, p) whatever the route says: (out, t, h_pre,
    m), the last three None in the eval variant."""
    ptrs, _keep, M, C = k3._kernel_operands(xs, y, **p)
    bf = dict(dtype=torch.bfloat16, device=xs.device)
    out = torch.empty_like(xs)
    t, h = torch.empty(M, C, **bf), torch.empty(M, 4 * C, **bf)
    h_pre = torch.empty(M, 4 * C, **bf) if train else None
    m = torch.empty(M, C, **bf) if train else None
    k3._wide(ptrs, out, t, h, h_pre, m, M, C, approximate, k3.WIDE_ALL,
             xs.dtype)
    return out, (t if train else None), h_pre, m


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_convnext_mlp_wide: no CUDA device is available",
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
    for line in (lib_path.parent / "convnext_mlp_wide.log").read_text(
            ).splitlines():
        if any(w in line for w in ("registers", "spill", "wgmma", "rror")):
            print(f"[ptxas] {line.strip()[:200]}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print("[card]", card, flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    bad = 0
    f32 = "--float32" in sys.argv
    dtype = torch.float32 if f32 else torch.bfloat16

    def held(got, ref):
        err = float((got.float() - ref.float()).abs().max())
        mean = float((got.float() - ref.float()).abs().mean())
        tol = float(ref.float().abs().max()) * 2 ** -6
        mean_tol = float(ref.float().abs().mean()) * 2 ** -12
        ok = err <= tol and mean <= mean_tol
        return ok, f"{err:.2e}/{tol:.2e} mean {mean:.2e}/{mean_tol:.2e}"

    timed = {}
    for C in WIDTHS:
        for M in ROWS:
            xs = torch.randn(M, C, generator=g, device=dev).to(dtype)
            y = torch.randn(M, C, generator=g, device=dev).to(dtype)
            p = cs.k3_params(torch, C, g, dev)
            for approximate in (True, False):
                if C in k3.WIDE_DIMS:
                    k3.convnext_mlp.wide_launches = 0
                    k3.convnext_mlp_train.wide_launches = 0
                    with torch.no_grad():
                        out = k3.convnext_mlp(xs, y, approximate=approximate,
                                              **p)
                        again = k3.convnext_mlp(xs, y,
                                                approximate=approximate, **p)
                    got = k3.convnext_mlp_train(xs, y,
                                                approximate=approximate, **p)
                    routed = (k3.convnext_mlp.wide_launches == 2
                              and k3.convnext_mlp_train.wide_launches == 1)
                else:
                    out = wide_call(torch, k3, xs, y, p, approximate, False)[0]
                    again = wide_call(torch, k3, xs, y, p, approximate,
                                      False)[0]
                    got = wide_call(torch, k3, xs, y, p, approximate, True)
                    routed = True
                ref = k3.convnext_mlp_train_plain(xs, y,
                                                  approximate=approximate, **p)
                torch.cuda.synchronize()
                ok, text = held(out, ref[0])
                line = f"C={C} M={M} approximate={approximate}: out {text}"
                for name, a, b in zip(("t", "h_pre", "m"), got[1:], ref[1:]):
                    good, text = held(a, b)
                    ok &= good
                    line += f" | {name} {text}{'' if good else ' BAD'}"
                same = torch.equal(out, got[0])
                twice = torch.equal(out, again)
                ok &= out.dtype == dtype
                line += (f" | train out {'equal' if same else 'DIFFERS'}"
                         f" | twice {'equal' if twice else 'DIFFERS'}")
                ok &= same and twice and routed
                # each stage on the plain version's own inputs
                t_ref = k3.ln_stage_plain(y, p["ln_w"], p["ln_b"])
                hp_ref, h_ref = k3.up_stage_plain(t_ref, p["w1"], p["b1"],
                                                  approximate)
                o_ref, m_ref = k3.down_stage_plain(h_ref, xs, p["w2"],
                                                   p["b2"], p["gamma"])
                stages = (
                    ("ln t", k3.ln_stage(y, p["ln_w"], p["ln_b"]), t_ref),
                    *zip(("up h_pre", "up h"),
                         k3.up_stage(t_ref, p["w1"], p["b1"], approximate),
                         (hp_ref, h_ref)),
                    *zip(("down out", "down m"),
                         k3.down_stage(h_ref, xs, p["w2"], p["b2"],
                                       p["gamma"]),
                         (o_ref, m_ref.to(torch.bfloat16))))
                torch.cuda.synchronize()
                for name, a, b in stages:
                    good, text = held(a, b)
                    ok &= good
                    line += f" | {name} {text}{'' if good else ' BAD'}"
                print(line + ("" if routed else " | NOT ROUTED")
                      + ("" if ok else " BAD"), flush=True)
                bad += not ok
                del out, again, got, ref, stages
            if M == ROWS[-1]:
                timed[C] = (xs, y, p)
            torch.cuda.empty_cache()

    if "--time" in sys.argv and not bad and f32:
        print(f"[time] ms a launch on {card}", flush=True)
        for C, (xs, y, p) in timed.items():
            if C not in k3.WIDE_DIMS:
                continue
            # W1 and W2 as a block hands them over: transposed views of
            # nn.Linear's float32 storage
            p = dict(p, w1=p["w1"].t().contiguous().t(),
                     w2=p["w2"].t().contiguous().t())
            for r in cs.time_k3_wide_f32(torch, xs, y, p):
                print(f"[time] C={C} {r['kernel']}: " + ", ".join(
                    f"{k} {r[k]:.4f}" for k in (
                        "ms", "mma_sync_ms", "stock_chain_ms", "plain_ms",
                        "bound_ms") if r.get(k) is not None), flush=True)
            t_in = k3.ln_stage(y, p["ln_w"], p["ln_b"])
            h_in = k3.up_stage(t_in, p["w1"], p["b1"], True)[1]
            with torch.no_grad():
                print(f"[time] C={C} stages (ln, up, down): " + ", ".join(
                    f"{v:.4f}" for v in (
                        cs.median_ms(torch, lambda: k3.ln_stage(
                            y, p["ln_w"], p["ln_b"])),
                        cs.median_ms(torch, lambda: k3.up_stage(
                            t_in, p["w1"], p["b1"], False)),
                        cs.median_ms(torch, lambda: k3.down_stage(
                            h_in, xs, p["w2"], p["b2"], p["gamma"]))))
                      + " ms", flush=True)
    elif "--time" in sys.argv and not bad:
        import torch.nn.functional as F
        print(f"[time] ms a launch on {card}", flush=True)
        for C, (xs, y, p) in timed.items():
            M = xs.shape[0]
            # W1 and W2 as a block hands them over: transposed views of
            # nn.Linear's float32 storage
            p = dict(p, w1=p["w1"].t().contiguous().t(),
                     w2=p["w2"].t().contiguous().t())
            w1t, w2t = k3.kernel_weights(p["w1"], p["w2"], "wide")
            b1, b2 = p["b1"].to(torch.bfloat16), p["b2"].to(torch.bfloat16)
            gam = p["gamma"].to(torch.bfloat16)
            t_in = k3.ln_stage(y, p["ln_w"], p["ln_b"])
            h_in = k3.up_stage(t_in, p["w1"], p["b1"], True)[1]

            def stock():
                t = F.layer_norm(y.float(), (C,), p["ln_w"], p["ln_b"],
                                 1e-6).to(torch.bfloat16)
                h = F.gelu(F.linear(t, w1t, b1), approximate="tanh")
                return xs + F.linear(h, w2t, b2) * gam

            def ms(fn, **kw):
                with torch.no_grad():
                    return cs.median_ms(torch, fn, **kw)

            r = {}
            for approximate in (True, False):
                tag = "tanh" if approximate else "erf"
                r[f"eval {tag}"] = ms(lambda: wide_call(
                    torch, k3, xs, y, p, approximate, False))
                r[f"train {tag}"] = ms(lambda: wide_call(
                    torch, k3, xs, y, p, approximate, True))
            r["ln"] = ms(lambda: k3.ln_stage(y, p["ln_w"], p["ln_b"]))
            r["up"] = ms(lambda: k3.up_stage(t_in, p["w1"], p["b1"], False))
            r["down"] = ms(lambda: k3.down_stage(h_in, xs, p["w2"], p["b2"],
                                                 p["gamma"]))
            if C in k3.WIDE_DIMS:
                route = k3.route
                k3.route = lambda dtype, C_: "mma"
                try:
                    r["eval mma.sync"] = ms(lambda: k3.convnext_mlp(
                        xs, y, approximate=True, **p))
                    r["train mma.sync"] = ms(lambda: k3.convnext_mlp_train(
                        xs, y, approximate=True, **p))
                finally:
                    k3.route = route
            else:
                r["eval wgmma kernel"] = ms(lambda: k3.convnext_mlp(
                    xs, y, approximate=True, **p))
            r["stock chain"] = ms(stock)
            r["plain"] = ms(lambda: k3.convnext_mlp_plain(
                xs, y, approximate=True, **p), warmup=1, iters=3)
            flops = 16 * M * C * C
            r["bound"] = cs.bound_ms(3 * M * C * 2 + 8 * C * C * 2, flops,
                                     cs.BF16_FLOPS)[0]
            print(f"[time] C={C} M={M}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in r.items()), flush=True)
            print(f"[time] C={C}: TFLOP/s eval erf "
                  f"{flops / r['eval erf'] / 1e9:.0f}, up (erf) "
                  f"{flops / 2 / r['up'] / 1e9:.0f}, down "
                  f"{flops / 2 / r['down'] / 1e9:.0f}", flush=True)
    print("FAILED" if bad else "ALL OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
