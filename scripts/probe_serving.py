#!/usr/bin/env python3
"""Probes of the port's serving paths on one NVIDIA GPU, at the flagship
(``ExperimentConfig()``, B=8, phase 3's seeded predictor of
``chip_smoke.py``):

    python3 scripts/probe_serving.py

1. Batch dependence: the serving forward on phase 3's 8 clips, and on the
   same 8 clips as the first half of 16. Every K2 and K3 call's input and
   output are compared between the two runs on the first 8 clips' rows;
   the first call whose input differs names the stock op before it.
2. The host timeline of one ``_predict_batches`` call over
   ``chip_smoke.py``'s stand-in dataset (4 batches of 8): when each batch
   is fetched, its pinned buffer waited for, its copy issued, handed over
   and its forward queued (ms from the call's start, by thread).
3. ``_predict_batches`` (each batch's probabilities read a batch later)
   against the same loop reading them at once, and the forward alone on
   the same batches, over 16 batches: host clock, median of 3 after a
   warm-up, four rounds in turns.

Prints the card's name and power limit first. Imports nothing of JAX.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def batch_dependence(torch, serve):
    """K2 and K3 calls of a forward on 8 clips against the same calls on
    those clips inside a batch of 16: (kernel, shape, max |Δ input|,
    max |Δ output|) per call."""
    from vision_collision_detection_tpu_torch.models.backbones import convnext

    first, rows = [], []

    def recording(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if len(first) < calls[0]:
                first.append((args[0].clone(), out.clone()))
            else:
                x0, y0 = first[len(rows)]
                n = x0.shape[0]
                rows.append((name, tuple(out.shape),
                             float((args[0][:n].float() - x0.float()).abs().max()),
                             float((out[:n].float() - y0.float()).abs().max())))
            return out
        return call

    calls = [36]  # 18 blocks, K2 and K3 each
    saved = convnext.dwconv7x7, convnext.convnext_mlp
    convnext.dwconv7x7 = recording("K2", saved[0])
    convnext.convnext_mlp = recording("K3", saved[1])
    try:
        frames = serve["frames"]
        serve["forward"](frames)
        serve["forward"](torch.cat([frames, frames.flip(0)]))
        torch.cuda.synchronize()
    finally:
        convnext.dwconv7x7, convnext.convnext_mlp = saved
    return rows


def timeline(torch, pred, ds):
    """(ms, thread, event) of one _predict_batches call over ``ds``."""
    from vision_collision_detection_tpu_torch.data import loader

    events, t0 = [], [0.0]

    def stamp(what):
        events.append((round((time.perf_counter() - t0[0]) * 1e3, 3),
                       threading.current_thread().name[:16], what))

    def wrapped(fn, before, after=None):
        def call(*args, **kw):
            stamp(before)
            out = fn(*args, **kw)
            if after:
                stamp(after)
            return out
        return call

    saved = (ds.get_batch, loader._wait_for_copy, loader._copy_to,
             loader._hand_over, pred._forward_cache.get(True))
    forward = pred._make_forward(True)
    ds.get_batch = wrapped(saved[0], "fetch", "fetched")
    loader._wait_for_copy = wrapped(saved[1], "ring wait", "ring free")
    loader._copy_to = wrapped(saved[2], "copy issued")
    loader._hand_over = wrapped(saved[3], "handed over")
    pred._forward_cache[True] = wrapped(forward, "forward", "forward queued")
    try:
        path_by_id = {f"clip{i:02d}": "" for i in range(len(ds.clips))}
        for _ in range(2):  # the second call is the one kept
            events.clear()
            torch.cuda.synchronize()
            t0[0] = time.perf_counter()
            pred._predict_batches(loader.ClipLoader(ds, 8), 2, path_by_id)
            torch.cuda.synchronize()
            stamp("done")
    finally:
        del ds.get_batch  # back to the class's method
        loader._wait_for_copy, loader._copy_to, loader._hand_over = saved[1:4]
        pred._forward_cache[True] = forward
    return events


def loop_ab(torch, cs, pred, clips):
    """ms of 16 batches: deferred read (the tree), read at once, forward
    alone; four rounds in turns."""
    from vision_collision_detection_tpu_torch.data.loader import (
        ClipLoader, device_feed)

    dev = pred.device
    ds = cs.StandInClips(clips, cs.BROKEN_CLIP, length=4 * len(clips))
    path_by_id = {f"clip{i:02d}": "" for i in range(len(clips))}
    forward = pred._make_forward(True)
    batches = [torch.from_numpy(clips[k:k + 8]).to(dev)
               for k in range(0, len(clips), 8)]

    def deferred():
        pred._predict_batches(ClipLoader(ds, 8), 2, path_by_id)

    def at_once():
        for batch in device_feed(iter(ClipLoader(ds, 8)), dev,
                                 keys=("frames",)):
            forward(batch["frames"]).cpu().numpy()

    def alone():
        for _ in range(4):
            for b in batches:
                forward(b)

    variants = {"deferred": deferred, "at_once": at_once, "alone": alone}
    rounds = {k: [] for k in variants}
    for order in [list(variants), list(variants)[::-1]] * 2:
        for k in order:
            rounds[k].append(cs.median_step_ms(torch, variants[k], 1, 3))
    return rounds


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_serving: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from vision_collision_detection_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build()
    dev = torch.device("cuda")
    serve = cs.serving_forward(torch, dev, power=False)

    print("[batch] kernel, output shape (16 clips), max |Δ input|, "
          "max |Δ output| on the first 8 clips:")
    for row in batch_dependence(torch, serve):
        print("[batch]", *row)

    g = torch.Generator().manual_seed(13)
    clips = torch.stack([
        torch.randint(12 * (i % 8), 256 - 16 * (i % 8),
                      (25, *cs.CONTENT, 3), generator=g, dtype=torch.uint8)
        for i in range(cs.N_CLIPS)]).numpy()
    for event in timeline(torch, serve["pred"],
                          cs.StandInClips(clips, cs.BROKEN_CLIP)):
        print("[timeline]", *event)
    for name, ms in loop_ab(torch, cs, serve["pred"], clips).items():
        print(f"[loop 16 batches] {name}: mean {sum(ms) / len(ms):.3f} ms, "
              f"rounds {', '.join(f'{t:.3f}' for t in ms)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
