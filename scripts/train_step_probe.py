#!/usr/bin/env python3
"""The training step's host issue time and the training preprocess's
counters over one run of the benchmark's training loop.

    python3 scripts/train_step_probe.py --config vivit_small --seed <n> --seconds <s>

Run it from the root of the checkout to measure, on a machine with a CUDA
card: it imports that checkout's program and benchmark. It runs
``benchmark/train.py`` as ``python3 -m benchmark.run`` runs a training cell
(``--config``'s configuration under the ``train_epochs`` traffic, so also a
configuration no cell trains, such as the flagship), with the
``Trainer``'s step timed on the host from its call to its return, with no
synchronise and no profiler: the time the host takes to issue a step. It
prints one JSON line: the card, the window's steps and clips per second,
the issue time per step over the window's steps (median and quartiles, in
ms), and the training preprocess's counters over the whole run: the fused
route's kernel launches (two a step) and the card's calls that took the
chain (``null`` where the program has none).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

T_START = time.perf_counter()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="vivit_small")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    from benchmark import harness, run
    from vision_collision_detection_tpu_torch.ops import preprocess

    man = harness.manifest()
    conf = next(c for c in man["configs"] if c["name"] == args.config)
    w = {"name": f"{args.config}.train", "config": args.config,
         "traffic": "train_epochs", "chips": 1,
         "c": harness.load_json(harness.ROOT / conf["file"]),
         "t": harness.load_json(harness.HERE / "traffic" / "train_epochs.json")}
    issue = []

    def timed(_where, tr):
        inner = tr.train_step

        def step(*a, **kw):
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            issue.append(time.perf_counter() - t0)
            return out

        tr.train_step = step

    # (counter's name, its holder): the kernels the fused route launched
    # (2 a step), the card's calls that took the chain; None where the
    # program has no such counter
    fused = getattr(preprocess, "fused_preprocess", None)
    holders = {"fused_launches": (getattr(fused, "fused_train_preprocess",
                                          None), "launches"),
               "plain_cuda_calls": (preprocess.train_preprocess,
                                    "plain_cuda_calls")}
    before = {k: getattr(f, a, None) for k, (f, a) in holders.items()}
    rec = run.drive(w, args.seed, args.seconds, False, "cuda", T_START,
                    fault=timed)
    counters = {k: (None if before[k] is None else getattr(f, a) - before[k])
                for k, (f, a) in holders.items()}
    window = issue[-rec["steps"]:]
    q = statistics.quantiles([t * 1e3 for t in window], n=4)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(json.dumps({
        "card": smi, "config": args.config, "seed": args.seed,
        "steps_all": len(issue), "window_steps": rec["steps"],
        "train_clips_per_s": rec["clips"] / rec["window_s"],
        "step_ms": rec["window_s"] / rec["steps"] * 1e3,
        "issue_ms": {"median": statistics.median(t * 1e3 for t in window),
                     "q1": q[0], "q3": q[2]},
        "counters": counters, "numbers": rec["numbers"],
        "peak_gib": rec["peak_bytes"] / 2 ** 30,
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
