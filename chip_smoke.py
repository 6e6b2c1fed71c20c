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
   shapes. Then the training path's kernels at the same shapes: K2 wgrad
   against its plain version relative to Σ|x·g| and bit-equal over two
   runs (flipped or transposed taps must land outside), K2 dx (the
   forward kernel on flipped taps, through the autograd Function) against
   autograd through the plain conv, and K3 train (out bit-equal to the
   eval kernel's; t, h_pre and m by K3's rule, with m saved without b2
   and h_pre saved after GELU landing outside).
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
6. Run one training step (``create_train_state(ExperimentConfig())`` and
   ``make_train_step``: convnext_tiny + bi-GRU, bf16, default
   augmentation) on a seeded uint8 batch [8, 50, 126, 224, 3] with all
   three classes: launch counts (K2 36, K2 wgrad 18, K3 train 18, K3 eval
   and K1 0), a finite loss, a finite gradient for every parameter and a
   nonzero one for every block parameter. The same step with every kernel
   swapped for its plain version must agree on the loss and each
   gradient (TRAIN_TOL), where γ's gradient off by 1% and a dropped K2
   bias gradient must not; the loss must fall over five steps on a fixed
   batch with augmentation off.
7. Time the training step with kernels and with stock blocks in turns,
   ``train_preprocess`` alone and the step's peak memory; profile one
   step: device time of K2 (forward and dx), K2 wgrad, K3 train, K3's
   torch backward, ``train_preprocess`` and the rest, and the idle share.

Prints one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import copy
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
WGRAD_TOL = 1e-6               # K2 wgrad error per tap and channel / Σ|x·g|
# Kernel step vs plain step: the loss and each parameter's gradient,
# relative (to the loss, to that gradient's norm). The two share every
# rounding but the kernels' sum order, so they differ by rare 1-ulp flips;
# γ's gradient off by 1% must land outside.
TRAIN_TOL = 5e-3
STEPS_PER_EPOCH = 100
TRAIN_SEED = 5                 # the step's generator (flips, augmentation, dropout)
TRAIN_FALL_STEPS = 5
TRAIN_TIME_ITERS = 5


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
    report["compare_train"] = compare_train_kernels(torch, dev,
                                                    compare["inputs"])
    serve = serving_forward(torch, dev)
    report["serving"] = serve["summary"]
    timing = time_kernels(torch, dev, compare["inputs"])
    del compare["inputs"]
    report["timing"] = timing

    forward_ms = time_forward(torch, serve)
    report["forward"] = forward_ms
    report["profile"] = profile_forward(torch, serve)
    del serve

    train = training_step(torch, dev)
    report["training"] = train["summary"]
    report["train_time"] = time_training(torch, dev, train)
    report["train_profile"] = profile_training(torch, train)

    launches = {"serve": report["serving"]["launches"],
                "train": train["summary"]["launches"]}
    kernels = kernel_line(
        compare["rows"] + report["compare_train"]["rows"], launches, timing)
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


def recorder(rows, failed):
    """→ record(name, shape, err, tol, ...): one comparison of a kernel with
    its plain version, appended to ``rows`` and, when outside its
    tolerance, to ``failed``. ``err`` is what ``tol`` bounds; ``abs_err``
    (default ``err``) is the largest absolute difference; ``entry`` is the
    kernel's key in the kernels line (default the name's first word)."""
    def record(name, shape, err, tol, mean=None, mean_tol=None,
               abs_err=None, entry=None):
        ok = err <= tol and (mean is None or mean <= mean_tol)
        rows.append({"kernel": name, "entry": entry or name.split()[0],
                     "shape": shape, "err": err, "tol": tol,
                     "max_abs_err": err if abs_err is None else abs_err,
                     "mean_abs_err": mean, "mean_tol": mean_tol, "ok": ok})
        extra = "" if mean is None else (
            f", mean_abs_err {mean:.3e} (tol {mean_tol:.3e})")
        log(f"[compare] {name} {shape}: err {err:.3e} "
            f"(tol {tol:.3e}){extra} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} {shape}")
    return record


def fault_seen(faults, failed, name, shape, seen, **numbers):
    """Record whether a fault written into a plain version lands outside the
    tolerance it is meant to test; a fault not seen fails the run."""
    faults.append({"fault": name, "shape": shape, "seen": seen, **numbers})
    log(f"[compare] fault {name} {shape}: "
        + ", ".join(f"{k} {v:.3e}" for k, v in numbers.items())
        + f": {'seen' if seen else 'NOT seen'}")
    if not seen:
        failed.append(f"fault {name} not seen at {shape}")


@contextlib.contextmanager
def swapped(*swaps):
    """Set each (module or class, attribute, value) for the block, then
    restore what was there."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in swaps]
    for obj, name, value in swaps:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


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
    record = recorder(rows, failed)

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


def compare_train_kernels(torch, dev, inputs):
    """The training path's kernels against their plain versions at the
    flagship shapes, on phase 2's K2 and K3 inputs (bf16): K2 wgrad (and
    bit-equal over two runs), K2 dx (the forward kernel on flipped taps,
    through the autograd Function, against autograd through the plain
    conv) and K3 train (out bit-equal to the eval kernel; t, h_pre, m held
    by K3's rule). Faulty plain versions must land outside each tolerance."""
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    g = torch.Generator().manual_seed(5)
    rows, faults, failed = [], [], []
    record = recorder(rows, failed)
    for H, C, _ in STAGES:
        shape = [N_FRAMES, H, H, C]
        x, w, b = inputs[("K2", C)]
        gy = torch.randn(N_FRAMES, H, H, C, generator=g).to(dev, torch.bfloat16)
        got = k2.dwconv7x7_wgrad(x, gy)
        again = k2.dwconv7x7_wgrad(x, gy)
        ref = k2.dwconv7x7_wgrad_plain(x, gy)
        # Σ|x·g| per tap and channel: the scale of a float32 sum's rounding
        scale = k2.dwconv7x7_wgrad_plain(x.abs(), gy.abs()).clamp_min(1e-30)
        torch.cuda.synchronize()

        def rel(a):
            return float(((a - ref).abs() / scale).max())

        # float32 sums of up to 627,200 products in another order: each
        # partial sum rounds at 2^-24 of its size, far under 1e-6 of Σ|x·g|,
        # while a wrong tap order is off by ~1/√(N·H·W) of it (≥ 1e-3 here)
        record("K2 wgrad (err / Σ|x·g|)", shape, rel(got), WGRAD_TOL,
               abs_err=max_err(torch, got, ref), entry="K2 wgrad")
        record("K2 wgrad twice (bit-equal)", shape,
               max_err(torch, got, again), 0.0, entry="K2 wgrad")
        taps = ref.view(7, 7, C)
        for name, bad in (("taps flipped", taps.flip(0, 1)),
                          ("dy and dx swapped", taps.transpose(0, 1))):
            err = rel(bad.reshape(49, C))
            fault_seen(faults, failed, f"K2 wgrad {name}", shape,
                       err > WGRAD_TOL, err=err)
        inputs[("K2 wgrad", C)] = (x, gy)

        # dx: the Function's backward against autograd through F.conv2d
        xr = x.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(k2.dwconv7x7(xr, w, b), xr, gy)
        xp = x.detach().requires_grad_(True)
        (dx_ref,) = torch.autograd.grad(k2.dwconv7x7_plain(xp, w, b), xp, gy)
        torch.cuda.synchronize()
        # float32 sums of 49 taps in another order, one bf16 rounding
        record("K2 dx", shape, max_err(torch, dx, dx_ref),
               float(dx_ref.float().abs().max()) * 2 ** -7)

        xs, y, p = inputs[("K3", C)]
        with torch.no_grad():
            out_eval = k3.convnext_mlp(xs, y, approximate=True, **p)
        out, t, h_pre, m = k3.convnext_mlp_train(xs, y, approximate=True, **p)
        ref = dict(zip(("out", "t", "h_pre", "m"), k3.convnext_mlp_train_plain(
            xs, y, approximate=True, **p)))
        torch.cuda.synchronize()
        # the same tile computes out in both variants
        record("K3 train out vs eval (bit-equal)", shape,
               max_err(torch, out, out_eval), 0.0, entry="K3 train")
        tols = {}
        for name, v in (("t", t), ("h_pre", h_pre), ("m", m)):
            r = ref[name]
            # K3's rule: rare 1-ulp flips of bf16 values, 2 ulps at the
            # largest, and a mean error under 2^-12 of the mean |value|
            tols[name] = (float(r.float().abs().max()) * 2 ** -6,
                          float(r.float().abs().mean()) * 2 ** -12)
            record(f"K3 train {name}", [N_FRAMES * H * H, v.shape[-1]],
                   max_err(torch, v, r), tols[name][0],
                   mean_err(torch, v, r), tols[name][1], entry="K3 train")
        # the backward's GELU and GELU′ lookups against the formulas
        h_tab, grad_tab = k3._gelu_tables(h_pre.device, True)
        idx = h_pre.view(torch.int16).int()
        hf = h_pre.float()
        record("K3 bwd GELU lookup (bit-equal)", [N_FRAMES * H * H, 4 * C],
               max(max_err(torch, h_tab[idx],
                           k3.gelu_f32(hf, True).to(torch.bfloat16)),
                   max_err(torch, grad_tab[idx], k3.gelu_grad_f32(hf, True))),
               0.0, entry="K3 train")
        del idx, hf
        bad = {"m saved without b2": ("m", m, (ref["m"].float() - p["b2"]).to(
                   torch.bfloat16)),
               "h_pre saved after GELU": ("h_pre", h_pre, k3.gelu_f32(
                   ref["h_pre"].float(), True).to(torch.bfloat16))}
        for fault, (name, v, wrong) in bad.items():
            err, mean = max_err(torch, v, wrong), mean_err(torch, v, wrong)
            fault_seen(faults, failed, f"K3 train {fault}", shape,
                       err > tols[name][0] or mean > tols[name][1],
                       max_abs_err=err, mean_abs_err=mean)
    if failed:
        raise SystemExit(f"training kernel disagrees with its plain version: "
                         f"{failed}")
    return {"rows": rows, "faults": faults}


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
        with swapped((convnext, "dwconv7x7", dw),
                     (convnext, "convnext_mlp", mlp),
                     (preprocess, "dequant_normalize_pad",
                      dequant_pad.dequant_normalize_pad_plain)):
            out = pred._make_forward(True)(frames_dev)
            torch.cuda.synchronize()
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


# ---- 3b. training step -------------------------------------------------

def train_counters():
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
    from vision_collision_detection_tpu_torch.ops import dequant_pad
    from vision_collision_detection_tpu_torch.ops import dwconv as k2

    return {"K1": dequant_pad.dequant_normalize_pad, "K2": k2.dwconv7x7,
            "K2 wgrad": k2.dwconv7x7_wgrad, "K3": k3.convnext_mlp,
            "K3 train": k3.convnext_mlp_train}


def rel_grad_errs(torch, got, ref):
    """Each parameter's gradient error relative to that gradient's norm."""
    return {n: float((got[n] - ref[n]).norm() / ref[n].norm().clamp_min(1e-30))
            for n in ref}


def training_step(torch, dev):
    """One optimizer step of the flagship through the port's entry points
    (``create_train_state``, ``make_train_step``) on a seeded uint8 batch
    [8, 50, 126, 224, 3]: launch counts, finite loss, a finite gradient
    for every parameter and a nonzero one for every block parameter; the
    same step with every kernel swapped for its plain version; faults in
    the backward that the comparison must see; the loss falling over
    TRAIN_FALL_STEPS steps on a fixed batch with augmentation off."""
    from vision_collision_detection_tpu_torch.config import ExperimentConfig
    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
    from vision_collision_detection_tpu_torch.ops import dwconv as k2
    from vision_collision_detection_tpu_torch.train import (
        create_train_state, make_train_step)

    cfg = ExperimentConfig()
    B, T = cfg.data.batch_size, cfg.data.num_frames
    model, state = create_train_state(cfg, torch.Generator().manual_seed(3),
                                      steps_per_epoch=STEPS_PER_EPOCH)
    step = make_train_step(model, cfg)
    g = torch.Generator().manual_seed(4)
    frames = torch.randint(0, 256, (B, T, *CONTENT, 3), generator=g,
                           dtype=torch.uint8).to(dev)
    targets = (torch.arange(B) % cfg.model.num_classes).to(dev)
    mask = torch.ones(B, device=dev)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt_init = copy.deepcopy(state.optimizer.state_dict())

    def run(seed, fn=step, keep_grads=True):
        """One step from the initial weights and optimizer state."""
        model.load_state_dict(init)
        state.optimizer.load_state_dict(opt_init)
        state.step = 0
        _, m = fn(state, frames, targets, mask,
                  torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        grads = ({n: p.grad.detach().float().clone()
                  for n, p in model.named_parameters()} if keep_grads else None)
        return {k: float(v) for k, v in m.items()}, grads

    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    metrics, grads = run(TRAIN_SEED)
    first_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"[train] first step {first_s:.2f} s, metrics {metrics}")
    log(f"[train] launches {launches}")
    expect = {"K1": 0, "K2": 36, "K2 wgrad": 18, "K3": 0, "K3 train": 18}
    if launches != expect:
        raise SystemExit(f"training launches {launches}, expected {expect}")
    if not math.isfinite(metrics["loss"]):
        raise SystemExit(f"non-finite loss {metrics}")
    bad = [n for n, v in grads.items() if not bool(torch.isfinite(v).all())]
    block_params = [n for n in grads if ".stage" in n and "_block" in n]
    n_blocks = len({n.split(".")[1] for n in block_params})
    zero = [n for n in block_params if float(grads[n].abs().max()) == 0.0]
    log(f"[train] {len(grads)} parameters with a gradient; non-finite "
        f"{bad}; {n_blocks} blocks, zero block gradients {zero}")
    if bad or zero or n_blocks != 18:
        raise SystemExit("a parameter's gradient is missing, non-finite or "
                         "zero")

    plain = ((k2, "_launch_fwd", k2.dwconv7x7_plain),
             (k2, "_launch_wgrad", k2.dwconv7x7_wgrad_plain),
             (k3, "_launch_train", k3.convnext_mlp_train_plain))
    with swapped(*plain):
        plain_metrics, plain_grads = run(TRAIN_SEED)
    loss_err = abs(metrics["loss"] - plain_metrics["loss"]) / abs(
        plain_metrics["loss"])
    errs = rel_grad_errs(torch, grads, plain_grads)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    log(f"[train] kernels vs plain: loss {metrics['loss']:.6f} vs "
        f"{plain_metrics['loss']:.6f} (rel {loss_err:.2e}); worst gradient "
        f"errors {[(n, f'{e:.2e}') for n, e in worst]} (tol {TRAIN_TOL:.0e})")
    if loss_err > TRAIN_TOL or worst[0][1] > TRAIN_TOL:
        raise SystemExit("training step disagrees with its plain version")

    # The comparison's power: faults in the backward, each in the plain step
    bwd, dw_bwd = k3.convnext_mlp_bwd, k2._DwConv7x7.backward

    def bwd_gamma_off(*args):
        grads_ = bwd(*args)
        return grads_[:-1] + (grads_[-1] * 1.01,)

    def dw_bwd_no_db(ctx, gy):
        dx, dw, db = dw_bwd(ctx, gy)
        return dx, dw, torch.zeros_like(db)

    with swapped(*plain, (k3, "convnext_mlp_bwd", bwd_gamma_off),
                 (k2._DwConv7x7, "backward", staticmethod(dw_bwd_no_db))):
        _, fault_grads = run(TRAIN_SEED)
    ferrs = rel_grad_errs(torch, fault_grads, grads)
    power = {"dgamma_1pct": min(e for n, e in ferrs.items()
                                if n.endswith(".gamma")),
             "k2_db_dropped": min(e for n, e in ferrs.items()
                                  if n.endswith(".dwconv.bias"))}
    log(f"[train] faults, least relative gradient error over the affected "
        f"parameters: {power} (must exceed tol {TRAIN_TOL:.0e})")
    if not all(v > TRAIN_TOL for v in power.values()):
        raise SystemExit(f"the tolerance does not see a backward fault: {power}")

    fixed_cfg = cfg.override({"augment.enabled": False,
                              "augment.horizontal_flip_prob": 0.0})
    fixed_step = make_train_step(model, fixed_cfg)
    model.load_state_dict(init)
    state.optimizer.load_state_dict(opt_init)
    losses = []
    for _ in range(TRAIN_FALL_STEPS):
        _, m = fixed_step(state, frames, targets, mask,
                          torch.Generator(device=dev).manual_seed(TRAIN_SEED))
        losses.append(float(m["loss"]))
    log(f"[train] fixed batch, augmentation off: losses {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"the loss did not fall: {losses}")
    return {"cfg": cfg, "model": model, "state": state, "step": step,
            "batch": (frames, targets, mask),
            "summary": {"launches": launches, "metrics": metrics,
                        "first_step_s": first_s,
                        "plain_metrics": plain_metrics,
                        "loss_rel_err": loss_err,
                        "worst_grad_rel_err": worst, "tol": TRAIN_TOL,
                        "faults_least_rel_err": power,
                        "fixed_batch_losses": losses}}


def median_step_ms(torch, fn, warmup, iters):
    """Host clock around each call, each ending in a synchronise; median."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_training(torch, dev, tr):
    """The training step with the kernels (the default) and with stock
    blocks, in turns (A B, B A), each the mean of its two medians; the
    share of ``train_preprocess``; peak device memory of a step."""
    from vision_collision_detection_tpu_torch.models import build_model
    from vision_collision_detection_tpu_torch.ops.preprocess import (
        train_preprocess)
    from vision_collision_detection_tpu_torch.train import (
        TrainState, build_optimizer, make_train_step)

    cfg = tr["cfg"]
    frames, targets, mask = tr["batch"]
    B = frames.shape[0]
    stock = build_model(cfg.model, device=dev, dwconv_kernel=False,
                        fused_mlp=False,
                        generator=torch.Generator().manual_seed(3))
    stock_state = TrainState(*build_optimizer(cfg.optim, stock.parameters(),
                                              STEPS_PER_EPOCH))
    variants = {"kernels": (tr["state"], tr["step"]),
                "stock": (stock_state, make_train_step(stock, cfg))}
    gen = torch.Generator(device=dev).manual_seed(7)

    def one(name):
        state, fn = variants[name]
        return lambda: fn(state, frames, targets, mask, gen)

    times = {name: [] for name in variants}
    for order in (list(variants), list(variants)[::-1]):
        for name in order:
            times[name].append(median_step_ms(torch, one(name), warmup=2,
                                              iters=TRAIN_TIME_ITERS))
    out = {}
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        out[name] = {"ms_per_step": ms, "clips_per_s": B / ms * 1e3,
                     "batch": B, "rounds_ms": ts}
        log(f"[train time] {name} blocks: {ms:.2f} ms per step of {B} clips, "
            f"{B / ms * 1e3:.2f} clips/s (rounds {ts[0]:.2f}, {ts[1]:.2f})")
    pre_ms = median_step_ms(torch, lambda: train_preprocess(
        gen, frames, cfg.augment, cfg.data.frame_size,
        getattr(torch, cfg.model.dtype)), warmup=1, iters=TRAIN_TIME_ITERS)
    out["train_preprocess_ms"] = pre_ms
    out["train_preprocess_share"] = pre_ms / out["kernels"]["ms_per_step"]
    del variants["stock"], stock, stock_state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    one("kernels")()
    torch.cuda.synchronize()
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[train time] train_preprocess {pre_ms:.2f} ms "
        f"({out['train_preprocess_share']:.3f} of the step); peak device "
        f"memory {out['peak_mem_bytes'] / 1e9:.2f} GB")
    return out


def profile_training(torch, tr):
    """Device time by kernel over one training step (torch.profiler): K2's
    forward kernel (forward and dx), K2 wgrad, K3 train, K3's torch
    backward and train_preprocess (each a record_function range around
    their calls), the rest; and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
    from vision_collision_detection_tpu_torch.train import steps

    def ranged(label, fn):
        def wrapped(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    frames, targets, mask = tr["batch"]
    gen = torch.Generator(device=frames.device).manual_seed(8)

    def run():
        tr["step"](tr["state"], frames, targets, mask, gen)

    with swapped((k3, "convnext_mlp_bwd",
                  ranged("vcd_k3_backward", k3.convnext_mlp_bwd)),
                 (steps, "train_preprocess",
                  ranged("vcd_train_preprocess", steps.train_preprocess))):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    ranges = {"K3 torch backward": "vcd_k3_backward",
              "train_preprocess": "vcd_train_preprocess"}
    rows = []
    for e in prof.key_averages():
        # a record_function range also shows as a device-side annotation
        # spanning its kernels: not a kernel of its own
        if (getattr(e, "device_type", None) != DeviceType.CUDA
                or e.key in ranges.values()):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append({"kernel": e.key, "ms": us / 1e3, "launches": e.count})
    busy = sum(r["ms"] for r in rows)
    if busy <= 0:
        log("[train profile] the profiler recorded no device time: "
            "not measured")
        return None
    groups = {"K2 fwd and dx": ("dwconv7x7_kernel",),
              "K2 wgrad": ("dwconv_wgrad_kernel", "wgrad_sum_parts"),
              "K3 train": ("convnext_mlp_kernel",)}
    by_group = {name: sum(r["ms"] for r in rows
                          if any(k in r["kernel"] for k in keys))
                for name, keys in groups.items()}
    for name, label in ranges.items():
        us = sum(e.device_time_total for e in prof.events()
                 if e.name == label and e.device_type == DeviceType.CPU)
        by_group[name] = us / 1e3 if us > 0 else None
    by_group["rest"] = busy - sum(v for v in by_group.values() if v)
    rows.sort(key=lambda r: -r["ms"])
    idle = max(0.0, 1.0 - busy / wall_ms)
    log(f"[train profile] device busy {busy:.2f} ms of {wall_ms:.2f} ms wall "
        f"per step (idle share {idle:.3f}); by part: "
        + ", ".join(f"{k} {v:.2f}" if v is not None else f"{k} not measured"
                    for k, v in by_group.items()))
    for r in rows[:15]:
        log(f"[train profile]   {r['ms']:.3f} ms x{r['launches']} "
            f"{r['kernel'][:100]}")
    return {"busy_ms": busy, "wall_ms": wall_ms, "idle_share": idle,
            "by_part_ms": by_group, "top": rows[:30]}


# ---- 4. timing ---------------------------------------------------------

def time_kernels(torch, dev, inputs):
    import torch.nn.functional as F

    from vision_collision_detection_tpu_torch.ops.convnext_mlp import (
        convnext_mlp, convnext_mlp_plain, convnext_mlp_train,
        convnext_mlp_train_plain)
    from vision_collision_detection_tpu_torch.ops.dequant_pad import (
        dequant_normalize_pad, dequant_normalize_pad_plain)
    from vision_collision_detection_tpu_torch.ops.dwconv import (
        dwconv7x7, dwconv7x7_plain, dwconv7x7_wgrad, dwconv7x7_wgrad_plain)

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

        # K2 wgrad: x and g read once, float32 dw written; 98 flops each
        gx, gy = inputs[("K2 wgrad", C)]
        b, by = bound_ms(2 * n * 2 + 49 * C * 4, 98 * n, F32_FLOPS)
        gy_cl = gy.permute(0, 3, 1, 2)
        rows.append({
            "kernel": "K2 wgrad", "shape": list(x.shape), "per_forward": blocks,
            "ms": median_ms(torch, lambda: dwconv7x7_wgrad(gx, gy)),
            "plain_ms": median_ms(torch, lambda: dwconv7x7_wgrad_plain(gx, gy)),
            # cuDNN's depthwise weight and bias gradient
            "library_ms": median_ms(
                torch, lambda: torch.ops.aten.convolution_backward(
                    gy_cl, x_cl, w_cudnn, [C], [1, 1], [3, 3], [1, 1], False,
                    [0, 0], C, [False, True, True])),
            "bound_ms": b, "bound_by": by})
        # K3 train: x, y, out, t, m at 2 bytes per row-channel and h_pre at
        # 8, W1 and W2 once; the eval kernel's flops
        b, by = bound_ms(18 * n + 8 * C * C * 2, 16 * M * C * C, BF16_FLOPS)
        rows.append({
            "kernel": "K3 train", "shape": list(x.shape), "per_forward": blocks,
            "ms": median_ms(torch, lambda: convnext_mlp_train(
                xs, y, approximate=True, **p)),
            "plain_ms": median_ms(torch, lambda: convnext_mlp_train_plain(
                xs, y, approximate=True, **p)),
            "library_ms": None, "bound_ms": b, "bound_by": by})
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


def kernel_line(compare_rows, launches, timing):
    """One entry per kernel. ``launches`` is the sum over the main paths'
    runs (the serving forward and the training step, each counted from 0),
    with the split in ``launches_by_path``; ms, plain_ms, bound_ms and
    library_ms cover one pass over the stages (K1: one launch; the others:
    the 18 launches of one pass through the blocks)."""
    csrc = "vision_collision_detection_tpu_torch/ops/csrc/"
    tpu = "vision_collision_detection_tpu/ops/"
    meta = {
        "K1": ("dequant_pad", csrc + "dequant_pad.cu",
               tpu + "pallas_ops.py:81"),
        "K2": ("dwconv7x7", csrc + "dwconv.cu", tpu + "dwconv_pallas.py:78"),
        "K2 wgrad": ("dwconv7x7_wgrad", csrc + "dwconv_wgrad.cu",
                     tpu + "dwconv_pallas.py:114"),
        "K3": ("convnext_mlp", csrc + "convnext_mlp.cu",
               tpu + "convnext_mlp_pallas.py:160"),
        "K3 train": ("convnext_mlp_train", csrc + "convnext_mlp.cu",
                     tpu + "convnext_mlp_pallas.py:160"),
    }
    out = []
    for k, (name, src, replaces) in meta.items():
        rows = [r for r in timing if r["kernel"] == k]
        errs = [r["max_abs_err"] for r in compare_rows if r["entry"] == k]
        by_path = {path: counts.get(k, 0) for path, counts in launches.items()}

        def total(key):
            vals = [r[key] for r in rows]
            if any(v is None for v in vals):
                return None
            return sum(v * r["per_forward"] for v, r in zip(vals, rows))

        by_ops = sum(r["bound_by"] == "operations" for r in rows)
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
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
