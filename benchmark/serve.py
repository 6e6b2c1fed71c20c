"""The serving driver: a closed loop of one client, each request one call
of the program's ``CollisionPredictor._predict_batches`` over a fresh
``ClipLoader`` on a stand-in dataset of the request's clips.

Set-up builds the predictor with the run's seeded weights, the pool of
distinct clips (in host memory, as a decoder would hand them over: folded
to every k-th frame where the model folds) and the request sequence, and
serves one request of each size the traffic sends. The window then sends
requests back to back until ``--seconds`` have passed and the last one has
returned; a request's latency runs from the call to the moment its result
dicts exist on the host. With ``--trace 1`` a fixed number of further
requests is traced. After the window, and after the program is freed, the
reference computes every pool clip's probabilities in float32 and every
answer of the window is compared with its clip's.
"""

from __future__ import annotations

import gc
import itertools
import math
import time

import numpy as np

from benchmark import harness, trace
from benchmark.harness import log


def make_requests(t: dict, seed: int, pool_n: int) -> list:
    """The request sequence: clip indices into the pool. Every block of
    consecutive requests holds each size of ``clips_per_request`` once, in
    an order drawn from ``seed``, so that every seed offers the same sizes;
    a request's clips are a run of distinct pool clips from an offset drawn
    from ``seed``, which the stand-in dataset hands over without a copy."""
    rng = np.random.default_rng(seed)
    sizes = list(t["clips_per_request"])
    out = []
    while len(out) < t["max_requests"]:
        for k in rng.permutation(sizes):
            start = int(rng.integers(0, pool_n - k + 1))
            out.append(np.arange(start, start + k))
    return out


def received(idx, results, class_names) -> np.ndarray:
    """A request's answers as probabilities [len(idx), C], a row of NaN
    where an answer is missing, failed or for another clip."""
    out = np.full((len(idx), len(class_names)), np.nan)
    if len(results) != len(idx):
        return out
    for j, (i, r) in enumerate(zip(idx, results)):
        if r.get("success") and r.get("id") == f"clip{int(i)}":
            out[j] = [r["probabilities"][n] for n in class_names]
    return out


def centred_log(p: np.ndarray) -> np.ndarray:
    """log-probabilities less their mean over the classes: the logits up to
    the shift that softmax takes out."""
    lp = np.log(np.maximum(np.asarray(p, np.float64), 1e-300))
    return lp - lp.mean(axis=-1, keepdims=True)


def reference_probs(c: dict, params, pool: np.ndarray, device, prec) -> np.ndarray:
    """Every pool clip's probabilities from the reference, 8 clips at a
    time."""
    import torch

    from benchmark.reference import models
    from benchmark.reference.preprocess import eval_frames
    from benchmark.reference.products import float32_math

    a = c["augment"]
    out = []
    with torch.no_grad(), float32_math():
        for i in range(0, len(pool), 8):
            u8 = torch.from_numpy(pool[i:i + 8]).to(device)
            x = eval_frames(u8, c["frame_size"], a["normalize_mean"],
                            a["normalize_std"])
            z = models.logits(params, x, c, prec)
            out.append(torch.softmax(z, dim=-1).cpu().numpy())
    return np.concatenate(out)


def judge(answers: list, ref: np.ndarray) -> dict:
    """Every answer (``received``) against its clip's reference
    probabilities: the widest gap of the centred log-probabilities, and the
    answers missing or wrong in kind (a failed clip, a clip out of place, a
    count that differs)."""
    idx = np.concatenate([i for i, _ in answers])
    got = np.concatenate([p for _, p in answers])
    ok = ~np.isnan(got).any(axis=1)
    gap = np.abs(centred_log(got[ok]) - centred_log(ref[idx[ok]]))
    return {"logit_gap": float(gap.max()) if ok.any() else float("inf"),
            "answers_missing": int((~ok).sum())}


def run(ctx: dict) -> dict:
    import torch

    from vision_collision_detection_tpu_torch.data.loader import ClipLoader
    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor)
    from benchmark.reference.weights import make_params

    w, dev = ctx["w"], ctx["device"]
    c, t = harness.for_kind(w["c"], "serve"), w["t"]
    sd = harness.seeds(ctx["seed"])
    cfg = harness.program_config(c)
    params = make_params(c, sd["weights"], dev)
    pred = CollisionPredictor(cfg, params, device=dev)
    harness.check_sizes(c, pred.model, cfg)
    del params
    if ctx.get("fault"):
        ctx["fault"]("predictor", pred)
    stride = pred._fold_stride()
    pool = harness.make_pool(c, t["pool_clips"], c["frames"] // stride,
                             sd["pool"], dev)
    requests = make_requests(t, sd["requests"], len(pool))
    path_by_id = {f"clip{i}": f"clip{i}.mp4" for i in range(len(pool))}

    def serve(idx):
        with trace.span(trace.REQUEST):
            loader = ClipLoader(harness.StandInClips(pool, idx),
                                t["loader_batch"])
            return pred._predict_batches(loader, stride, path_by_id)

    for k in sorted(set(t["clips_per_request"])):  # each shape the traffic sends
        serve(np.arange(k) % len(pool))
    sync = (lambda: torch.cuda.synchronize()) if dev != "cpu" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - ctx["t_start"]
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    answers, latencies = [], []
    it = itertools.cycle(requests)
    names = pred.class_names
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx["seconds"]:
        idx = next(it)
        ts = time.perf_counter()
        res = serve(idx)
        latencies.append(time.perf_counter() - ts)
        answers.append((idx, received(idx, res, names)))
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    clips = sum(len(i) for i, _ in answers)
    batches = sum(math.ceil(len(i) / t["loader_batch"]) for i, _ in answers)
    out = {"kind": "serve", "c": c, "t": t, "setup_s": setup_s,
           "window_s": window_s, "clips": clips, "batches": batches,
           "latencies_s": latencies, "peak_bytes": peak,
           "attempted": len(answers)}
    if ctx["trace"]:
        traced = [next(it) for _ in range(t["traced_requests"])]
        before = harness.counters(c)
        out["slice"] = trace.profile(lambda: [serve(i) for i in traced])
        out["slice_counters"] = harness.counter_delta(before, harness.counters(c))
        out["slice_batches"] = sum(math.ceil(len(i) / t["loader_batch"])
                                   for i in traced)
        out["slice_requests"] = len(traced)
        log(f"traced {len(traced)} requests, {out['slice_batches']} batches: "
            f"launches {out['slice_counters']}")
    del pred
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()

    from benchmark.reference.products import FLOAT32

    ref = reference_probs(c, make_params(c, sd["weights"], dev), pool, dev,
                          FLOAT32)
    out["numbers"] = judge(answers, ref)
    out["limits"] = {"logit_gap": c["limits"]["logit_gap"],
                     "answers_missing": 0}
    return out
