"""What the serving and training drivers share: the manifest and the cell's
files, the seeds, the clip pool and the stand-in dataset, the program's
configuration, its counters, and the metric readers.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. It names a
configuration (``benchmark/configs/<config>.json``: the sizes as run, the
augmentation and optimizer settings, and ``program``, the overrides that
make the program's ``ExperimentConfig`` of it) and a traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``kind`` picks the driver,
``serve`` or ``train``). Every metric is a file of its own,
``benchmark/metrics/<name>.py``, whose ``read(ctx)`` returns a number or
None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from benchmark import architectures
from benchmark.reference.training import derive_seed

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "vision_collision_detection_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, man: Optional[dict] = None) -> dict:
    """The cell ``name`` with its configuration and traffic files read."""
    man = man or manifest()
    found = [w for w in man["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = dict(found[0])
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    w["c"] = load_json(ROOT / conf["file"])
    w["t"] = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    return w


def metrics_of(name: str, man: dict, trace: bool) -> list:
    """The metric entries this cell reports: with ``trace`` the per-layer
    ones, else the end-to-end ones; an entry without ``workloads`` is
    reported where the end-to-end metric it moves is (per-layer) or in every
    cell (end-to-end)."""
    if not trace:
        return [m for m in man["end_to_end"]
                if name in m.get("workloads", [name])]
    e2e = {m["name"] for m in metrics_of(name, man, False)}
    return [m for m in man["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in e2e else [])]


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, ctx: dict) -> Dict[str, dict]:
    out = {}
    for m in entries:
        v = reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def for_kind(c: dict, kind: str) -> dict:
    """Configuration ``c`` as a ``kind`` of traffic runs it: a setting given
    by kind (``{"serve": ..., "train": ...}``) resolved."""
    return {k: v[kind] if isinstance(v, dict) and set(v) == {"serve", "train"}
            else v for k, v in c.items()}


def seeds(seed: int) -> Dict[str, int]:
    """The run's seeds, each drawn from ``--seed`` for one purpose."""
    names = ("weights", "pool", "requests", "train", "data", "labels")
    return {n: derive_seed(seed, "benchmark", n) % (2 ** 62) for n in names}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---- the program's configuration ------------------------------------------------

def program_config(c: dict, **more):
    """The program's ``ExperimentConfig`` of configuration ``c``: its
    ``program`` overrides, its augmentation and optimizer settings, and
    ``more``."""
    from vision_collision_detection_tpu_torch.config import ExperimentConfig

    over = dict(c["program"])
    for group in ("augment", "optim"):
        for k, v in c[group].items():
            over[f"{group}.{k}"] = tuple(v) if isinstance(v, list) else v
    over.update(more)
    return ExperimentConfig().override(over)


def check_sizes(c: dict, model, cfg) -> None:
    """The program builds what the configuration file states: every
    parameter's name and shape (``load_state_dict(strict=True)`` checks the
    rest) and the frames and batch."""
    from benchmark.reference.weights import param_spec

    own = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith(("running_mean", "running_var",
                              "num_batches_tracked"))}
    want = {n: tuple(s) for n, s, _ in param_spec(c)}
    if own != want:
        diff = sorted(set(own.items()) ^ set(want.items()))[:6]
        raise SystemExit(f"the program's model is not the configuration's: {diff}")
    if (cfg.data.num_frames, cfg.data.frame_size, cfg.data.batch_size,
            cfg.model.dtype) != (c["frames"], c["frame_size"], c["batch_size"],
                                 c["compute_dtype"]):
        raise SystemExit("the program's frames, side, batch or dtype differ "
                         "from the configuration's")


# ---- inputs -------------------------------------------------------------------------

def make_pool(c: dict, n: int, frames: int, seed: int, device) -> np.ndarray:
    """``n`` distinct uint8 clips [n, frames, ch, cw, 3] of letterbox content,
    made on ``device`` from ``seed``, 8 at a time: each a smooth random
    image (a 4×7 grid of colours, bilinear) under noise of ±32 that changes
    from frame to frame, so that clips differ in what they show."""
    import torch
    import torch.nn.functional as F

    ch, cw = c["content"]
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = np.empty((n, frames, ch, cw, 3), np.uint8)
    for i in range(0, n, 8):
        k = min(8, n - i)
        coarse = torch.rand(k, 3, 4, 7, generator=g, device=device) * 255
        smooth = F.interpolate(coarse, size=(ch, cw), mode="bilinear",
                               align_corners=False)
        noise = torch.rand(k, frames, 3, ch, cw, generator=g,
                           device=device) * 64 - 32
        clips = (smooth[:, None] + noise).clamp(0, 255).to(torch.uint8)
        out[i:i + k] = clips.permute(0, 1, 3, 4, 2).cpu().numpy()
    return out


class StandInClips:
    """A dataset of uint8 content clips that needs no decoder: ``get_batch``
    returns the collated dict of the program's ``ClipDataset.get_batch``,
    whose frames are a view of the pool where the batch's clips are a run of
    it (a copy where not, as a shuffled training batch). ``index`` maps the
    dataset's items to clips of ``pool``; ``labels`` are the items' classes.
    Each fetch is a benchmark span."""

    supports_batch = True

    def __init__(self, pool, index, labels=None):
        self.pool, self.index = pool, np.asarray(index, np.int64)
        self._labels = (np.zeros(len(self.index), np.int64) if labels is None
                        else np.asarray(labels, np.int64))

    def __len__(self):
        return len(self.index)

    def labels(self):
        return self._labels

    def class_weights(self):
        from benchmark.reference.training import class_weights

        return class_weights(self._labels, 3)

    def get_batch(self, idxs, epoch=0, num_threads=0):
        from benchmark.trace import FETCH, span

        with span(FETCH):
            idxs = np.asarray(idxs, np.int64)
            clips = self.index[idxs]
            b, t = len(idxs), self.pool.shape[1]
            run = np.array_equal(clips, np.arange(clips[0], clips[0] + b))
            return {"frames": (self.pool[clips[0]:clips[0] + b] if run
                               else self.pool[clips]),
                    "sensor": np.zeros((b, t, 4), np.float32),
                    "target": self._labels[idxs],
                    "id": [f"clip{int(i)}" for i in clips],
                    "error": np.zeros(b, bool),
                    "pad": np.zeros(b, bool)}


# ---- the program's counters ---------------------------------------------------------

# key → (the program's module, the function or object that holds the
# counters, their attribute names); an architecture adds its own kernels'
# in its module's ``COUNTERS``
COUNTERS = {
    "K1": ("ops.dequant_pad", "dequant_normalize_pad", ("launches",)),
    "K2": ("ops.dwconv", "dwconv7x7", ("launches", "hopper_launches")),
    "K2_wgrad": ("ops.dwconv", "dwconv7x7_wgrad", ("launches", "hopper_launches")),
    "K3": ("ops.convnext_mlp", "convnext_mlp",
           ("launches", "wgmma_launches", "wide_launches")),
    "K3_train": ("ops.convnext_mlp", "convnext_mlp_train",
                 ("launches", "wgmma_launches", "wide_launches")),
    "K4": ("ops.flash_attention", "flash_mha", ("launches", "wgmma_launches")),
    "K4_dkv": ("ops.flash_attention", "flash_mha_bwd_dkv",
               ("launches", "wgmma_launches")),
    "K4_dq": ("ops.flash_attention", "flash_mha_bwd_dq",
              ("launches", "wgmma_launches")),
    "K4_di": ("ops.flash_attention", "flash_mha_bwd_di", ("launches",)),
    # the feed's producer thread, which a trace of the main thread does not
    # show: feeds started, batches yielded, ns waiting on the loader and in
    # ``stage``, pinned buffers allocated and their bytes
    "device_feed": ("data.loader", "device_feed",
                    ("feeds", "batches", "next_ns", "stage_ns", "pin_allocs",
                     "pinned_bytes")),
}


def _holder(mod: str, fn: str):
    return getattr(importlib.import_module(
        "vision_collision_detection_tpu_torch." + mod), fn)


def counters(c: dict) -> Dict[str, int]:
    """The program's counters (``COUNTERS`` and those of configuration
    ``c``'s architecture), read as they stand; a counter the program lacks
    reads 0."""
    table = dict(COUNTERS, **getattr(architectures.get(c["architecture"]),
                                     "COUNTERS", {}))
    out = {}
    for key, (mod, fn, attrs) in table.items():
        f = _holder(mod, fn)
        for a in attrs:
            out[f"{key}.{a}"] = int(getattr(f, a, 0))
    return out


def feed_counters() -> Optional[Dict[str, int]]:
    """``device_feed``'s counters as they stand, or None where the program
    has none."""
    mod, fn, attrs = COUNTERS["device_feed"]
    f = _holder(mod, fn)
    if not all(hasattr(f, a) for a in attrs):
        return None
    return {a: int(getattr(f, a)) for a in attrs}


def counter_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cache_dirs(root: Path) -> None:
    """Every kernel cache of the run at a fixed path inside the checkout
    (the program's own build goes to ``build/torch_kernels``)."""
    base = root / "build" / "benchmark_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(base / "nv_compute"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
