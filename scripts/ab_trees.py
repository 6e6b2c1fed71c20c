#!/usr/bin/env python3
"""Two checkouts of the port on one NVIDIA GPU, timed in turns: the B=8
serving forward and training step of the flagship and of the scaled ViViT.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/ab_trees.py build/parent [CHANGE_DIR]

CHANGE_DIR defaults to this checkout. Each tree runs in its own process
(parent, change, change, parent), builds its own kernels under its own
``build/`` and times, on seeded random weights and uint8 batches:

- the flagship forward (``CollisionPredictor._make_forward(folded_stride=
  True)`` on [8, 25, 126, 224, 3]) and the ViViT forward (vivit_small, 32
  frames of 189×336 into 336², ``attention_impl="flash"``), CUDA events,
  median of 10 after 3 warm-ups;
- each model's training step (``make_train_step`` on [8, 50, 126, 224, 3]
  and [8, 32, 189, 336, 3]), host clock around a step that ends in a
  synchronise, median of 5 after 2 warm-ups.

Prints each round, then each metric's mean of two rounds per tree and the
difference. Comparing within one call keeps both trees on the same card;
between calls a card and its neighbours change. Imports nothing of JAX.
Exits non-zero without a CUDA device or when a tree's run fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import json, statistics, sys, time, torch
sys.path.insert(0, sys.argv[1])
from vision_collision_detection_tpu_torch.ops import _build
_build.build()
_build.lib()
from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.infer.predictor import (
    CollisionPredictor)
from vision_collision_detection_tpu_torch.train import (
    create_train_state, make_train_step)

dev = torch.device("cuda")


def event_ms(fn, warm=3, iters=10):
    for _ in range(warm):
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


def host_ms(fn, warm=2, iters=5):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


VIVIT = {"model.backbone": "vivit_small", "model.temporal_mode": "attention",
         "model.patch_size": 14, "data.fps": 8, "data.duration": 4,
         "data.frame_size": 336, "augment.blur_sigma": 0.0,
         "model.attention_impl": "flash"}
out = {}
g = torch.Generator().manual_seed(0)
for tag, cfg, content in (
        ("flagship", ExperimentConfig(), (126, 224)),
        ("vivit", ExperimentConfig().override(VIVIT), (189, 336))):
    pred = CollisionPredictor(cfg, None)
    folded = tag == "flagship"
    forward = pred._make_forward(folded_stride=folded)
    T = cfg.data.num_frames // (pred._fold_stride() if folded else 1)
    frames = torch.randint(0, 256, (8, T, *content, 3), generator=g,
                           dtype=torch.uint8).to(dev)
    out[tag + " forward"] = event_ms(lambda: forward(frames))
    del pred, forward, frames
    model, state = create_train_state(cfg, torch.Generator().manual_seed(3),
                                      steps_per_epoch=100)
    step = make_train_step(model, cfg)
    frames = torch.randint(0, 256, (8, cfg.data.num_frames, *content, 3),
                           generator=g, dtype=torch.uint8).to(dev)
    targets = (torch.arange(8) % cfg.model.num_classes).to(dev)
    mask = torch.ones(8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    out[tag + " step"] = host_ms(
        lambda: step(state, frames, targets, mask, gen))
    del model, state, step, frames
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
'''


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_trees: no CUDA device is available", file=sys.stderr)
        return 1
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": os.path.abspath(sys.argv[1]),
             "change": os.path.abspath(sys.argv[2]) if len(sys.argv) > 2
             else ROOT}
    print("[card]", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    rounds = {name: [] for name in trees}
    for name in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, "-c", CHILD, trees[name]],
                              capture_output=True, text=True)
        found = [line for line in proc.stdout.splitlines()
                 if line.startswith("RESULT ")]
        if proc.returncode or not found:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            print(f"ab_trees: the {name} tree's run failed", file=sys.stderr)
            return 1
        result = json.loads(found[0][len("RESULT "):])
        rounds[name].append(result)
        print(f"[{name}] " + ", ".join(f"{k} {v:.3f} ms"
                                       for k, v in result.items()),
              flush=True)
    for key in rounds["parent"][0]:
        p = [r[key] for r in rounds["parent"]]
        c = [r[key] for r in rounds["change"]]
        print(f"[ab] {key}: parent {sum(p) / 2:.3f} (rounds {p[0]:.3f}, "
              f"{p[1]:.3f}), change {sum(c) / 2:.3f} (rounds {c[0]:.3f}, "
              f"{c[1]:.3f}), change − parent {(sum(c) - sum(p)) / 2:+.3f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
