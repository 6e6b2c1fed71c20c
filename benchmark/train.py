"""The training driver: the program's ``Trainer`` over a stand-in dataset of
distinct seeded clips, its ``_train_epoch`` run epoch after epoch with
validation off and no checkpoint, as a training job spends most of its
time.

Set-up builds the ``Trainer`` (its model and AdamW state), loads the run's
seeded weights into that model, and runs epoch 0 through the same
``_train_epoch`` the window runs; the first ``checked_steps`` steps of it
are recorded from the ``Trainer``'s own state: each step's loss, each
leaf's first gradient as AdamW holds it after one step (‖m₁‖/(1 − β₁)), and
each leaf's change over those steps. The same ``Trainer`` then goes into
the window: whole epochs back to back until ``--seconds`` have passed; the
rate counts every step's clips over the whole time of those epochs. With
``--trace 1`` one more epoch is traced. After the window, and after the
program is freed, the reference replays the recorded steps from the same
weights, batches and step seeds, in float32.
"""

from __future__ import annotations

import gc
import shutil
import statistics
import tempfile
import time

import numpy as np

from benchmark import harness, trace
from benchmark.harness import log


def record_steps(tr, checked: int, beta1: float) -> dict:
    """Wrap ``tr.train_step`` on the instance: a benchmark span around each
    call, and the first ``checked`` steps recorded."""
    import torch

    inner = tr.train_step
    names = [n for n, _ in tr.model.named_parameters()]
    params = [p for _, p in tr.model.named_parameters()]
    rec = {"calls": 0, "losses": [], "names": names}

    def step(state, frames, targets, mask, generator, **kw):
        with trace.span(trace.STEP):
            if rec["calls"] == 0:
                rec["p0"] = [p.detach().clone() for p in params]
            state, m = inner(state, frames, targets, mask, generator, **kw)
            rec["calls"] += 1
            n = rec["calls"]
            if n <= checked:
                with torch.no_grad():
                    rec["losses"].append(m["loss"].detach().clone())
                    if n == 1:
                        opt = state.optimizer.state
                        # a parameter the optimizer never took has no moment
                        rec["first_grad"] = torch.stack([
                            opt[p]["exp_avg"].norm() if "exp_avg" in opt[p]
                            else p.new_zeros(()) for p in params]) / (1 - beta1)
                    if n == checked:
                        rec["change"] = torch.stack([
                            (p.detach() - q).norm()
                            for p, q in zip(params, rec.pop("p0"))])
            return state, m

    tr.train_step = step
    return rec


def gaps(prog: dict, ref: dict, names: list) -> dict:
    """The numbers a configuration may compare (its ``limits`` name them):
    for each leaf, the gap between the program's and the reference's norms
    of the first gradient, and of the change over the recorded steps, each
    against the larger of that leaf's reference norm and the median leaf's;
    taken by the worst leaf (``grad_gap``, ``change_gap``), by the median
    leaf, or as the root mean square over the leaves (``grad_gap_rms``, a
    steady number where one small leaf's noise swings the worst). Leaves
    whose reference gradient is under a thousandth of the median leaf's (a
    key's bias under softmax) move by round-off alone under AdamW and are
    left out of the change. And each step's loss gap, against the larger of
    that step's reference loss and the mean of the recorded steps'
    (``loss_gap``), and the first step's (``first_loss_gap``)."""
    lp, lr = np.asarray(prog["losses"]), np.asarray(ref["losses"])
    gr = np.asarray([ref["first_grad"][n] for n in names])
    cr = np.asarray([ref["change"][n] for n in names])
    gp, cp = np.asarray(prog["first_grad"]), np.asarray(prog["change"])
    gmed = statistics.median(gr)
    keep = gr >= 1e-3 * gmed
    cmed = statistics.median(cr[keep])
    g = np.abs(gp - gr) / np.maximum(gr, gmed)
    ch = np.abs(cp - cr)[keep] / np.maximum(cr[keep], cmed)
    kept = [n for n, k in zip(names, keep) if k]
    lmean = float(np.mean(np.abs(lr)))
    return {"loss_gap": float(np.max(np.abs(lp - lr)
                                     / np.maximum(np.abs(lr), lmean))),
            "grad_gap": float(g.max()), "change_gap": float(ch.max()),
            "grad_gap_median": float(np.median(g)),
            "grad_gap_rms": float(np.sqrt(np.mean(g ** 2))),
            "change_gap_median": float(np.median(ch)),
            "first_loss_gap": float(abs(lp[0] - lr[0]) / abs(lr[0])),
            "worst_grad_leaf": names[int(g.argmax())],
            "worst_change_leaf": kept[int(ch.argmax())],
            "leaves_left_out": [n for n, k in zip(names, keep) if not k]}


def run(ctx: dict) -> dict:
    import torch

    from vision_collision_detection_tpu_torch.train import Trainer
    from benchmark.reference import training
    from benchmark.reference.weights import make_params

    w, dev = ctx["w"], ctx["device"]
    c, t = harness.for_kind(w["c"], "train"), w["t"]
    sd = harness.seeds(ctx["seed"])
    cfg = harness.program_config(c, **{
        "train.validation_freq": 0, "train.checkpoint_every_epochs": 0,
        "train.seed": sd["train"], "data.seed": sd["data"]})
    B, n = c["batch_size"], t["pool_clips"]
    pool = harness.make_pool(c, n, c["frames"], sd["pool"], dev)
    labels = np.random.default_rng(sd["labels"]).permutation(n) % c["num_classes"]
    train_ds = harness.StandInClips(pool, np.arange(n), labels)
    val_ds = harness.StandInClips(pool, np.arange(B), labels[:B])
    run_dir = tempfile.mkdtemp(prefix="bench_trainer_")
    try:
        tr = Trainer(cfg, train_ds, val_ds, run_dir=run_dir, device=dev)
        params = make_params(c, sd["weights"], dev)
        tr.model.load_state_dict(params, strict=True)
        harness.check_sizes(c, tr.model, cfg)
        del params
        if ctx.get("fault"):
            ctx["fault"]("trainer", tr)
        checked = t["checked_steps"]
        rec = record_steps(tr, checked, c["optim"]["beta1"])
        spe = tr.steps_per_epoch
        tr._train_epoch(0)
        prog = {"losses": torch.stack(rec["losses"]).tolist(),
                "first_grad": rec["first_grad"].tolist(),
                "change": rec["change"].tolist()}
        names = rec["names"]
        sync = (lambda: torch.cuda.synchronize()) if dev != "cpu" else (lambda: None)
        sync()
        setup_s = time.perf_counter() - ctx["t_start"]
        if dev != "cpu":
            torch.cuda.reset_peak_memory_stats()
        gc.collect()
        gc.freeze()  # set-up's objects stay out of the window's collections
        epoch, t0 = 1, time.perf_counter()
        while True:
            tr._train_epoch(epoch)
            epoch += 1
            if time.perf_counter() - t0 >= ctx["seconds"]:
                break
        sync()
        window_s = time.perf_counter() - t0
        gc.unfreeze()
        peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
        steps = (epoch - 1) * spe
        out = {"kind": "train", "c": c, "t": t, "setup_s": setup_s,
               "window_s": window_s, "steps": steps, "clips": steps * B,
               "peak_bytes": peak, "attempted": steps}
        if ctx["trace"]:
            before = harness.counters(c)
            out["slice"] = trace.profile(lambda: tr._train_epoch(epoch))
            out["slice_counters"] = harness.counter_delta(before,
                                                          harness.counters(c))
            out["slice_steps"] = spe
            log(f"traced one epoch of {spe} steps: launches "
                f"{out['slice_counters']}")
        del tr, rec
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()

    order = training.epoch_order(n, sd["data"], 0)
    batches, seeds = [], []
    for i in range(checked):
        idx = order[i * B:(i + 1) * B]
        batches.append((torch.from_numpy(pool[idx]).to(dev),
                        torch.from_numpy(labels[idx]).to(dev),
                        torch.ones(B, device=dev)))
        seeds.append(training.step_seed(sd["train"], 0, i))
    weights = torch.from_numpy(training.class_weights(labels, c["num_classes"])
                               ).to(dev)
    ref = training.replay(make_params(c, sd["weights"], dev), c, batches, seeds,
                          weights, spe)
    ref = {"losses": ref["losses"].tolist(),
           "first_grad": {k: float(v) for k, v in ref["first_grad"].items()},
           "change": {k: float(v) for k, v in ref["change"].items()}}
    numbers = gaps(prog, ref, names)
    out["leaves"] = {"names": names, "program": prog, "reference": ref}
    out["limits"] = dict(c["limits"])
    out["numbers"] = {k: numbers[k] for k in out["limits"]}
    out["diagnostics"] = {k: v for k, v in numbers.items()
                          if k not in out["limits"] and not k.startswith(
                              ("worst", "leaves"))}
    out["diagnostics"].update(losses_program=prog["losses"],
                              losses_reference=ref["losses"])
    log("gaps: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items()
                             if isinstance(v, float)))
    log(f"losses: program {prog['losses']}, reference {ref['losses']}; "
        f"first step's gap {numbers['first_loss_gap']!r}")
    log(f"worst leaves: gradient {numbers['worst_grad_leaf']}, change "
        f"{numbers['worst_change_leaf']}; left out of the change: "
        f"{numbers['leaves_left_out']}")
    return out
