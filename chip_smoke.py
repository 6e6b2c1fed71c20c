#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card and ``nvcc`` (it
builds the kernels from ``vision_collision_detection_tpu_torch/ops/csrc``)
and imports nothing of JAX or of the JAX package. Phases, each fatal on
failure:

1. Build the kernels; print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card at the
   flagship shapes (K1 at N=200, 126×224 → 224 writing bf16 and float32;
   K2 and K3 at the four ConvNeXt stage shapes, K3 with tanh and erf
   GELU), random weights with layer-scale γ of order 1, TF32 off for the
   plain side. K3 is held on its largest and its mean error, and faulty
   plain versions (γ off by 1%, b2 dropped, the other GELU form) must land
   outside those tolerances. Then the variants off the main path (K3 at
   the base/large widths, K2 and K3 on float32 activations) at small
   shapes.
3. Run the serving forward (``CollisionPredictor`` with the default
   ``ExperimentConfig``: convnext_tiny + bi-GRU, seeded weights with γ
   re-drawn of order 1, biases and LayerNorms redrawn, and ``fc_out``
   scaled so the probabilities spread) on a seeded uint8 batch
   [8, 25, 126, 224, 3], each clip of its own level and contrast, through
   ``_make_forward(folded_stride=True)``. Check the probabilities and their
   spread across clips, that K1 launched once and K2 and K3 18 times each,
   and that the result matches the same forward with every kernel swapped
   for its plain version; then that the plain forward with a dropped K2 or
   K3 bias lands outside that tolerance (smaller faults are reported).
4. Time each kernel, its plain version, cuDNN's depthwise conv beside K2
   (``library_ms``), the stock LN→Linear→GELU→Linear chain beside K3 (for
   information; it is not one call), and the whole forward (both kernels,
   K2 only, K3 only, stock blocks) with CUDA events, as medians after
   warm-up.
5. Profile three forwards with ``torch.profiler``: device time by kernel
   and the device's idle share.

Prints one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM
BF16_FLOPS = 989e12            # dense tensor-core bf16
F32_FLOPS = 67e12              # CUDA-core float32 (FMA = 2 flops)

N_FRAMES = 200                 # B=8 clips × 25 folded frames
CONTENT = (126, 224)           # 16:9 source letterboxed into 224²
S = 224
STAGES = ((56, 96, 3), (28, 192, 3), (14, 384, 9), (7, 768, 3))  # (H=W, C, blocks)
LOGIT_SCALE = 10.0             # fc_out weights × this in the serving forward
SPREAD_MIN = 0.05              # least spread of one class's probability across clips


def log(*a):
    print(*a, flush=True)


def median_ms(torch, fn, warmup=3, iters=10):
    for _ in range(warmup):
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
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(n_bytes, n_ops, peak_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, a, b):
    return float((a.float() - b.float()).abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vision_collision_detection_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report = {}

    # ---- 1. build -------------------------------------------------------
    t0 = time.time()
    lib_path = _build.build()
    _build.lib()
    report["build_s"] = time.time() - t0
    log(f"[build] {lib_path} in {report['build_s']:.1f} s")
    for logf in sorted(lib_path.parent.glob("*.log")):
        for line in logf.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {logf.stem}] {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi_line = smi.splitlines()[0]
    log(f"[card] {smi_line}")
    report["card"] = smi_line

    compare = compare_kernels(torch, dev)
    report["compare"] = compare
    serve = serving_forward(torch, dev)
    report["serving"] = serve["summary"]
    timing = time_kernels(torch, dev, compare["inputs"])
    del compare["inputs"]
    report["timing"] = timing

    forward_ms = time_forward(torch, serve)
    report["forward"] = forward_ms
    report["profile"] = profile_forward(torch, serve)

    kernels = kernel_line(compare, serve["summary"]["launches"], timing)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report["kernels"] = kernels
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---- 2. kernel vs plain ------------------------------------------------

def k3_params(torch, C, g, dev):
    def n(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    def u(*shape):
        return (torch.rand(*shape, generator=g) + 0.5).to(dev)

    return dict(ln_w=u(C), ln_b=n(C, std=0.1), w1=n(C, 4 * C, std=C ** -0.5),
                b1=n(4 * C, std=0.1), w2=n(4 * C, C, std=(4 * C) ** -0.5),
                b2=n(C, std=0.1), gamma=u(C))


def mean_err(torch, a, b):
    return float((a.float() - b.float()).abs().mean())


# Faults a K3 could have, written as changes to what its plain version is
# given: (parameters, approximate) → (parameters, approximate). A check has
# power where the fault lands outside its tolerance and the kernel inside.
K3_ARGS = ("ln_w", "ln_b", "w1", "b1", "w2", "b2", "gamma")
K3_FAULTS = {
    "gamma_1pct": lambda p, ap: (dict(p, gamma=p["gamma"] * 1.01), ap),
    "b2_dropped": lambda p, ap: (dict(p, b2=p["b2"] * 0), ap),
    # tanh for erf: less than a bf16 ulp of h apart, but in every row
    "gelu_form": lambda p, ap: (p, not ap),
}


def compare_kernels(torch, dev):
    from vision_collision_detection_tpu_torch.ops.convnext_mlp import (
        convnext_mlp, convnext_mlp_plain)
    from vision_collision_detection_tpu_torch.ops.dequant_pad import (
        dequant_normalize_pad, dequant_normalize_pad_plain)
    from vision_collision_detection_tpu_torch.ops.dwconv import (
        dwconv7x7, dwconv7x7_plain)

    g = torch.Generator().manual_seed(1)
    rows, faults, failed = [], [], []
    inputs = {}

    def record(name, shape, err, tol, mean=None, mean_tol=None):
        ok = err <= tol and (mean is None or mean <= mean_tol)
        rows.append({"kernel": name, "shape": shape, "max_abs_err": err,
                     "tol": tol, "mean_abs_err": mean, "mean_tol": mean_tol,
                     "ok": ok})
        extra = "" if mean is None else (
            f", mean_abs_err {mean:.3e} (tol {mean_tol:.3e})")
        log(f"[compare] {name} {shape}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e}){extra} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} {shape}")

    mean, std = (0.45,) * 3, (0.225,) * 3
    u8 = torch.randint(0, 256, (N_FRAMES, *CONTENT, 3), generator=g,
                       dtype=torch.uint8).to(dev)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = dequant_normalize_pad(u8, S, mean, std, out_dtype)
        ref = dequant_normalize_pad_plain(u8, S, mean, std, out_dtype)
        torch.cuda.synchronize()
        if got.dtype != out_dtype:
            raise SystemExit(f"K1 wrote {got.dtype}, asked for {out_dtype}")
        # the same float32 formula, product rounded before the sum, one
        # rounding to the output dtype: bit-equal
        name = "K1" if out_dtype == torch.bfloat16 else "K1 float32"
        record(name, [N_FRAMES, *CONTENT, 3], max_err(torch, got, ref), 0.0)
    inputs["K1"] = (u8, mean, std)

    for H, C, _ in STAGES:
        x = torch.randn(N_FRAMES, H, H, C, generator=g).to(dev, torch.bfloat16)
        w = (torch.randn(49, C, generator=g) / 7).to(dev, torch.bfloat16)
        b = (torch.randn(C, generator=g) * 0.1).to(dev, torch.bfloat16)
        got = dwconv7x7(x, w, b)
        ref = dwconv7x7_plain(x, w, b)
        torch.cuda.synchronize()
        # float32 sums in another order, then one bf16 rounding: 1 ulp at
        # the largest magnitude
        tol = float(ref.float().abs().max()) * 2 ** -7
        record("K2", [N_FRAMES, H, H, C], max_err(torch, got, ref), tol)
        inputs[("K2", C)] = (x, w, b)

        xs = torch.randn(N_FRAMES, H, H, C, generator=g).to(dev, torch.bfloat16)
        p = k3_params(torch, C, g, dev)
        for approximate in (True, False):
            got = convnext_mlp(xs, x, approximate=approximate, **p)
            ref = convnext_mlp_plain(xs, x, approximate=approximate, **p)
            torch.cuda.synchronize()
            # bf16 roundings of t and h_pre can flip by 1 ulp where the
            # float32 sums differ in order; 2 ulps at the largest output.
            # Such flips are rare, so the mean error stays under 2^-12 of
            # the mean |output|, where a fault in every row would not.
            tol = float(ref.float().abs().max()) * 2 ** -6
            mean_tol = float(ref.float().abs().mean()) * 2 ** -12
            record(f"K3 approximate={approximate}", [N_FRAMES, H, H, C],
                   max_err(torch, got, ref), tol,
                   mean_err(torch, got, ref), mean_tol)
        # ref, tol and mean_tol are those of approximate=False
        for fault, change in K3_FAULTS.items():
            fp, fap = change(p, False)
            bad = convnext_mlp_plain(xs, x, approximate=fap, **fp)
            err, mean = max_err(torch, bad, ref), mean_err(torch, bad, ref)
            seen = err > tol or mean > mean_tol
            faults.append({"fault": fault, "shape": [N_FRAMES, H, H, C],
                           "max_abs_err": err, "mean_abs_err": mean,
                           "seen": seen})
            log(f"[compare] K3 with fault {fault} {[N_FRAMES, H, H, C]}: "
                f"max_abs_err {err:.3e}, mean_abs_err {mean:.3e}: "
                f"{'seen' if seen else 'NOT seen'}")
            if not seen:
                failed.append(f"K3 fault {fault} not seen at C={C}")
        inputs[("K3", C)] = (xs, x, p)

    # The other compiled variants, off the main path: K3 at the convnext
    # base/large widths, and K2 and K3 on float32 activations. A row
    # count that is no multiple of any block's rows exercises the tail.
    rows_off = 2000
    for C in (128, 256, 512, 1024, 1536):
        xs = torch.randn(rows_off, C, generator=g).to(dev, torch.bfloat16)
        y = torch.randn(rows_off, C, generator=g).to(dev, torch.bfloat16)
        p = k3_params(torch, C, g, dev)
        got = convnext_mlp(xs, y, approximate=True, **p)
        ref = convnext_mlp_plain(xs, y, approximate=True, **p)
        torch.cuda.synchronize()
        record(f"K3 width {C}", [rows_off, C], max_err(torch, got, ref),
               float(ref.float().abs().max()) * 2 ** -6)
    xs = torch.randn(rows_off, 96, generator=g).to(dev)
    y = torch.randn(rows_off, 96, generator=g).to(dev)
    p = k3_params(torch, 96, g, dev)
    for approximate in (True, False):
        got = convnext_mlp(xs, y, approximate=approximate, **p)
        ref = convnext_mlp_plain(xs, y, approximate=approximate, **p)
        torch.cuda.synchronize()
        # float32 residual: the bf16 roundings of t, h_pre and h still flip
        record(f"K3 float32 approximate={approximate}", [rows_off, 96],
               max_err(torch, got, ref), float(ref.abs().max()) * 2 ** -6)
    x = torch.randn(8, 56, 56, 96, generator=g).to(dev)
    w = (torch.randn(49, 96, generator=g) / 7).to(dev)
    b = (torch.randn(96, generator=g) * 0.1).to(dev)
    got = dwconv7x7(x, w, b)
    ref = dwconv7x7_plain(x, w, b)
    torch.cuda.synchronize()
    # float32 sums of 49 taps in another order
    record("K2 float32", [8, 56, 56, 96], max_err(torch, got, ref),
           float(ref.abs().max()) * 2 ** -16)
    if failed:
        raise SystemExit(f"kernel disagrees with its plain version: {failed}")
    return {"rows": rows, "faults": faults, "inputs": inputs}


# ---- 3. serving forward ------------------------------------------------

def serving_forward(torch, dev):
    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)
    from vision_collision_detection_tpu_torch.models.backbones import convnext
    from vision_collision_detection_tpu_torch.ops import (
        convnext_mlp, dequant_pad, dwconv, preprocess)

    cfg = ExperimentConfig()
    pred = CollisionPredictor(cfg, None)  # seeded weights, on the card
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        # Every bias and LayerNorm redrawn, as the CPU tests do, so that a
        # kernel that dropped one would show: biases N(0, 0.1²), LayerNorm
        # scales 1 + N(0, 0.1²).
        for name, p in pred.model.named_parameters():
            if name.endswith("bias") and p.dim() == 1:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        for m in pred.model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.copy_(1 + torch.randn(m.weight.shape, generator=g) * 0.1)
            if isinstance(m, convnext.ConvNeXtBlock):
                # γ of order 1: the init 1e-6 makes each block an identity
                m.gamma.copy_(torch.rand(m.dim, generator=g) + 0.5)
        # spread the logits so the probabilities are far from uniform
        pred.model.fc_out.weight.mul_(LOGIT_SCALE)
    T = cfg.data.num_frames // pred._fold_stride()
    # noise of another level and contrast in each clip, so the clips differ
    frames = torch.stack([
        torch.randint(12 * i, 256 - 16 * i, (T, *CONTENT, 3), generator=g,
                      dtype=torch.uint8) for i in range(8)])
    forward = pred._make_forward(folded_stride=True)
    frames_dev = frames.to(dev)
    torch.cuda.synchronize()

    counters = (dequant_pad.dequant_normalize_pad, dwconv.dwconv7x7,
                convnext_mlp.convnext_mlp)
    for fn in counters:
        fn.launches = 0
    probs = forward(frames_dev)
    torch.cuda.synchronize()
    launches = {"K1": counters[0].launches, "K2": counters[1].launches,
                "K3": counters[2].launches}
    log(f"[serve] probs {probs.tolist()}")
    log(f"[serve] launches {launches}")
    expect = {"K1": 1, "K2": 18, "K3": 18}
    if launches != expect:
        raise SystemExit(f"launches {launches}, expected {expect}")
    if tuple(probs.shape) != (8, 3) or not bool(torch.isfinite(probs).all()):
        raise SystemExit(f"bad probabilities {probs}")
    row_err = float((probs.sum(-1) - 1).abs().max())
    if row_err > 1e-5:
        raise SystemExit(f"probability rows do not sum to 1 ({row_err})")

    spread = {"min": float(probs.min()), "max": float(probs.max()),
              "across_clips": float((probs.max(0).values
                                     - probs.min(0).values).max())}
    log(f"[serve] probabilities span {spread['min']:.4f}..{spread['max']:.4f}; "
        f"largest spread of one class across clips {spread['across_clips']:.4f}")
    if spread["across_clips"] < SPREAD_MIN:
        raise SystemExit(f"probabilities too alike to test with ({spread})")

    def plain_forward(mlp=convnext_mlp.convnext_mlp_plain,
                      dw=dwconv.dwconv7x7_plain):
        """The same forward with every kernel swapped for its plain version
        (``mlp`` in place of K3, ``dw`` in place of K2)."""
        swaps = [(convnext, "dwconv7x7", dw),
                 (convnext, "convnext_mlp", mlp),
                 (preprocess, "dequant_normalize_pad",
                  dequant_pad.dequant_normalize_pad_plain)]
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        try:
            out = pred._make_forward(True)(frames_dev)
            torch.cuda.synchronize()
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        return out

    err = max_err(torch, probs, plain_forward())
    # bf16 activations through 18 blocks: 1-ulp flips between kernel and
    # plain sums propagate; probabilities must agree to 2e-2 absolute
    tol = 2e-2
    log(f"[serve] kernels vs plain: max |Δprob| {err:.3e} (tol {tol:.0e})")
    if not err <= tol:
        raise SystemExit("serving forward disagrees with its plain version")

    # The check's power: the plain forward with one fault in every block.
    # A dropped bias must land outside the tolerance; the smaller faults
    # are reported (phase 2's mean error sees them).
    def k3_with(change):
        def mlp(x, y, *args):
            p, ap = change(dict(zip(K3_ARGS, args[:7])), args[7])
            return convnext_mlp.convnext_mlp_plain(x, y, approximate=ap, **p)
        return mlp

    power = {name: max_err(torch, probs, plain_forward(mlp=k3_with(change)))
             for name, change in K3_FAULTS.items()}
    power["dwconv_bias_dropped"] = max_err(torch, probs, plain_forward(
        dw=lambda x, w, b: dwconv.dwconv7x7_plain(x, w, b * 0)))
    required = ("b2_dropped", "dwconv_bias_dropped")
    for name, v in power.items():
        log(f"[serve] with fault {name}: max |Δprob| {v:.3e} "
            f"({'must exceed' if name in required else 'beside'} tol "
            f"{tol:.0e})")
    if not all(power[name] > tol for name in required):
        raise SystemExit(f"the tolerance does not see a dropped bias: {power}")
    return {"pred": pred, "forward": forward, "frames": frames_dev,
            "summary": {"launches": launches, "probs": probs.tolist(),
                        "max_abs_err_vs_plain": err, "tol": tol,
                        "spread": spread, "faults_max_abs_err": power,
                        "row_sum_err": row_err}}


# ---- 4. timing ---------------------------------------------------------

def time_kernels(torch, dev, inputs):
    import torch.nn.functional as F

    from vision_collision_detection_tpu_torch.ops.convnext_mlp import (
        convnext_mlp, convnext_mlp_plain)
    from vision_collision_detection_tpu_torch.ops.dequant_pad import (
        dequant_normalize_pad, dequant_normalize_pad_plain)
    from vision_collision_detection_tpu_torch.ops.dwconv import (
        dwconv7x7, dwconv7x7_plain)

    rows = []
    u8, mean, std = inputs["K1"]
    n_bytes = u8.numel() + N_FRAMES * S * S * 3 * 2
    b, by = bound_ms(n_bytes, 0, BF16_FLOPS)
    rows.append({
        "kernel": "K1", "shape": list(u8.shape), "per_forward": 1,
        "ms": median_ms(torch, lambda: dequant_normalize_pad(u8, S, mean, std)),
        "plain_ms": median_ms(
            torch, lambda: dequant_normalize_pad_plain(u8, S, mean, std)),
        "library_ms": None, "bound_ms": b, "bound_by": by})
    for H, C, blocks in STAGES:
        x, w, bias = inputs[("K2", C)]
        n = x.numel()
        b, by = bound_ms(2 * n * 2 + 50 * C * 2, 98 * n, F32_FLOPS)
        w_cudnn = w.t().reshape(C, 1, 7, 7).contiguous()
        x_cl = x.permute(0, 3, 1, 2)  # channels_last view, no copy
        rows.append({
            "kernel": "K2", "shape": list(x.shape), "per_forward": blocks,
            "ms": median_ms(torch, lambda: dwconv7x7(x, w, bias)),
            "plain_ms": median_ms(torch, lambda: dwconv7x7_plain(x, w, bias)),
            "library_ms": median_ms(torch, lambda: F.conv2d(
                x_cl, w_cudnn, bias, padding=3, groups=C)),
            "bound_ms": b, "bound_by": by})
        xs, y, p = inputs[("K3", C)]
        M = n // C
        b, by = bound_ms(3 * n * 2 + 8 * C * C * 2, 16 * M * C * C,
                         BF16_FLOPS)
        w1t = p["w1"].t().contiguous().to(torch.bfloat16)
        w2t = p["w2"].t().contiguous().to(torch.bfloat16)
        b1, b2 = p["b1"].to(torch.bfloat16), p["b2"].to(torch.bfloat16)
        gam = p["gamma"].to(torch.bfloat16)

        def stock():
            t = F.layer_norm(y.float(), (C,), p["ln_w"], p["ln_b"],
                             1e-6).to(torch.bfloat16)
            h = F.gelu(F.linear(t, w1t, b1), approximate="tanh")
            return xs + F.linear(h, w2t, b2) * gam

        rows.append({
            "kernel": "K3", "shape": list(x.shape), "per_forward": blocks,
            "ms": median_ms(torch, lambda: convnext_mlp(
                xs, y, approximate=True, **p)),
            "plain_ms": median_ms(torch, lambda: convnext_mlp_plain(
                xs, y, approximate=True, **p)),
            "library_ms": None,
            "stock_chain_ms": median_ms(torch, stock),
            "bound_ms": b, "bound_by": by})
    for r in rows:
        log(f"[time] {r['kernel']} {r['shape']} x{r['per_forward']}: "
            f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; plain {r['plain_ms']:.4f}; library "
            f"{r['library_ms']}; stock chain {r.get('stock_chain_ms')})")
    return rows


def time_forward(torch, serve):
    """The serving forward with both kernels in the blocks (the default),
    with one of them, and with stock blocks, timed in turns: A B C D, then
    D C B A; each variant's time is the mean of its two medians."""
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)

    frames = serve["frames"]
    B = frames.shape[0]
    forwards = {"kernels": serve["forward"]}
    for name, dw, mlp in (("k2_only", True, False), ("k3_only", False, True),
                          ("stock", False, False)):
        pred = CollisionPredictor(serve["pred"].cfg, None, dwconv_kernel=dw,
                                  fused_mlp=mlp)
        forwards[name] = pred._make_forward(True)
    times = {name: [] for name in forwards}
    for order in (list(forwards), list(forwards)[::-1]):
        for name in order:
            fwd = forwards[name]
            times[name].append(
                median_ms(torch, lambda: fwd(frames), warmup=2, iters=10))
    out = {}
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        out[name] = {"ms_per_batch": ms, "clips_per_s": B / ms * 1e3,
                     "batch": B, "rounds_ms": ts}
        log(f"[forward] {name} blocks: {ms:.3f} ms per batch of {B}, "
            f"{B / ms * 1e3:.2f} clips/s (rounds {ts[0]:.3f}, {ts[1]:.3f})")
    torch.cuda.reset_peak_memory_stats()
    serve["forward"](frames)
    torch.cuda.synchronize()
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return out


def profile_forward(torch, serve):
    """Device time by kernel over three serving forwards (torch.profiler),
    and the device's idle share of the window's wall time (inflated by
    the profiler's own cost on the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fwd, frames = serve["forward"], serve["frames"]
    n = 3
    fwd(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fwd(frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append({"kernel": e.key, "ms": us / 1e3 / n,
                     "launches": e.count / n})
    busy = sum(r["ms"] for r in rows)
    if busy <= 0:
        log("[profile] the profiler recorded no device time: not measured")
        return None
    groups = {"K1": "dequant_pad_kernel", "K2": "dwconv7x7_kernel",
              "K3": "convnext_mlp_kernel"}
    by_group = {g: sum(r["ms"] for r in rows if key in r["kernel"])
                for g, key in groups.items()}
    by_group["other"] = busy - sum(by_group.values())
    rows.sort(key=lambda r: -r["ms"])
    idle = max(0.0, 1.0 - busy / wall_ms)
    log(f"[profile] device busy {busy:.3f} ms of {wall_ms:.3f} ms wall per "
        f"forward (idle share {idle:.3f}); by kernel: "
        + ", ".join(f"{g} {v:.3f}" for g, v in by_group.items()))
    for r in rows[:12]:
        log(f"[profile]   {r['ms']:.3f} ms x{r['launches']:.0f} "
            f"{r['kernel'][:100]}")
    return {"busy_ms": busy, "wall_ms": wall_ms, "idle_share": idle,
            "by_group_ms": by_group, "top": rows[:25]}


def kernel_line(compare, launches, timing):
    meta = {
        "K1": ("dequant_pad",
               "vision_collision_detection_tpu_torch/ops/csrc/dequant_pad.cu",
               "vision_collision_detection_tpu/ops/pallas_ops.py:81"),
        "K2": ("dwconv7x7",
               "vision_collision_detection_tpu_torch/ops/csrc/dwconv.cu",
               "vision_collision_detection_tpu/ops/dwconv_pallas.py:78"),
        "K3": ("convnext_mlp",
               "vision_collision_detection_tpu_torch/ops/csrc/convnext_mlp.cu",
               "vision_collision_detection_tpu/ops/convnext_mlp_pallas.py:160"),
    }
    out = []
    for k, (name, src, replaces) in meta.items():
        rows = [r for r in timing if r["kernel"] == k]
        errs = [r["max_abs_err"] for r in compare["rows"]
                if r["kernel"].split()[0] == k]

        def total(key):
            vals = [r[key] for r in rows]
            if any(v is None for v in vals):
                return None
            return sum(v * r["per_forward"] for v, r in zip(vals, rows))

        by_ops = sum(r["bound_by"] == "operations" for r in rows)
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[k],
            "max_abs_err": max(errs), "ms": total("ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "operations" if 2 * by_ops > len(rows) else "bytes",
            "library_ms": total("library_ms")})
    for r in out:
        if not all(math.isfinite(r[k]) for k in ("ms", "plain_ms", "bound_ms")):
            raise SystemExit(f"non-finite timing in {r}")
    return out


if __name__ == "__main__":
    sys.exit(main())
