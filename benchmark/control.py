"""The readings that a cell's limits are set from, on the card at the cell's
own size, many seeds in one process:

    python3 -m benchmark.control --workload <name> --seeds 1 2 3 [--program-seconds 2] [--out FILE]

For each seed:

- ``program``: a run of the cell (``run.drive``, a short window) and the
  numbers it compares: the lower readings;
- ``control``: the reference put in the program's place and computed with
  its products in fp8 (``Products("fp8")``), judged against the float32
  reference by the same numbers: a serving cell's pool clips, a training
  cell's replayed steps;
- training cells, ``half_batch``: the replay with half of each batch left
  out and the loss's mean taken over the rest, judged likewise. A step
  that returns its state unchanged reads 1 on ``change_gap`` by its
  definition and needs no run.

Each seed's readings go to standard output as one JSON line, and all of
them to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import time

import numpy as np

from benchmark import harness, run


def serve_control(w: dict, seed: int, device) -> dict:
    from benchmark import serve
    from benchmark.reference.products import FLOAT32, Products
    from benchmark.reference.weights import make_params

    c, t = harness.for_kind(w["c"], "serve"), w["t"]
    sd = harness.seeds(seed)
    stride = (c["frame_subsample"] if c.get("frame_subsample", 1) > 1
              and c["frames"] > c["subsample_threshold"] else 1)
    pool = harness.make_pool(c, t["pool_clips"], c["frames"] // stride,
                             sd["pool"], device)
    params = make_params(c, sd["weights"], device)
    ref = serve.reference_probs(c, params, pool, device, FLOAT32)
    low = serve.reference_probs(c, params, pool, device, Products("fp8"))
    gap = float(np.abs(serve.centred_log(low) - serve.centred_log(ref)).max())
    spread = serve.centred_log(ref)
    return {"control": {"logit_gap": gap},
            "reference_logits": {"max_abs": float(np.abs(spread).max()),
                                 "std_across_clips": float(spread.std(axis=0).mean()),
                                 "top_prob_mean": float(ref.max(-1).mean())}}


def train_control(w: dict, seed: int, device) -> dict:
    import torch

    from benchmark import train
    from benchmark.reference import training
    from benchmark.reference.products import Products
    from benchmark.reference.weights import make_params

    c, t = harness.for_kind(w["c"], "train"), w["t"]
    sd = harness.seeds(seed)
    B, n = c["batch_size"], t["pool_clips"]
    pool = harness.make_pool(c, n, c["frames"], sd["pool"], device)
    labels = np.random.default_rng(sd["labels"]).permutation(n) % c["num_classes"]
    order = training.epoch_order(n, sd["data"], 0)
    checked, spe = t["checked_steps"], n // B
    weights = torch.from_numpy(training.class_weights(labels, c["num_classes"])
                               ).to(device)

    def batches(half=False):
        out = []
        for i in range(checked):
            idx = order[i * B:(i + 1) * B]
            mask = torch.ones(B, device=device)
            if half:
                mask[B // 2:] = 0.0
            out.append((torch.from_numpy(pool[idx]).to(device),
                        torch.from_numpy(labels[idx]).to(device), mask))
        return out

    seeds = [training.step_seed(sd["train"], 0, i) for i in range(checked)]

    def replay(prec=None, half=False):
        r = training.replay(make_params(c, sd["weights"], device), c,
                            batches(half), seeds, weights, spe,
                            **({"prec": prec} if prec else {}))
        names = list(r["first_grad"])
        return names, {"losses": r["losses"].tolist(),
                       "first_grad": {k: float(v) for k, v in r["first_grad"].items()},
                       "change": {k: float(v) for k, v in r["change"].items()}}

    names, ref = replay()
    out = {"leaves": {"names": names, "reference": ref}}
    for key, kw in (("control", {"prec": Products("fp8")}),
                    ("half_batch", {"half": True})):
        _, other = replay(**kw)
        out["leaves"][key] = other
        prog = {"losses": other["losses"],
                "first_grad": [other["first_grad"][k] for k in names],
                "change": [other["change"][k] for k in names]}
        g = train.gaps(prog, ref, names)
        out[key] = {k: v for k, v in g.items()
                    if not k.startswith(("worst", "leaves"))}
        out[key + "_worst"] = [g["worst_grad_leaf"], g["worst_change_leaf"]]
    out["reference_losses"] = ref["losses"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program-seconds", type=float, default=2.0)
    p.add_argument("--no-program", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    harness.cache_dirs(harness.ROOT)
    import torch

    if not torch.cuda.is_available():
        harness.log("control: no CUDA card")
        return 2
    w = harness.cell(args.workload)
    rows = []
    for seed in args.seeds:
        row = {"workload": w["name"], "seed": seed}
        if not args.no_program:
            rec = run.drive(w, seed, args.program_seconds, False, "cuda",
                            time.perf_counter())
            row["program"] = dict(rec["numbers"], **rec.get("diagnostics", {}))
            row["program_correct"] = run.correct(rec)
            if "leaves" in rec:
                row["program_leaves"] = rec["leaves"]
            row["program_metrics"] = {
                k: v["value"] for k, v in harness.read_metrics(
                    harness.metrics_of(w["name"], harness.manifest(), False),
                    rec).items()}
            del rec
            gc.collect()
            torch.cuda.empty_cache()
        fn = serve_control if w["t"]["kind"] == "serve" else train_control
        with (torch.no_grad() if w["t"]["kind"] == "serve"
              else contextlib.nullcontext()):
            row.update(fn(w, seed, "cuda"))
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({k: v for k, v in row.items()
                          if "leaves" not in k}), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
