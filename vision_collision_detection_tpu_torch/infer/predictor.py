"""Batch inference: checkpoint or weights → per-clip collision probabilities.

Counterpart of ``vision_collision_detection_tpu/infer/predictor.py``
(``CollisionPredictor``):

- ``from_checkpoint`` rebuilds the architecture from the checkpoint's
  ``hyperparams`` contract (a run directory resolves best → last → newest
  epoch); ``from_torch_checkpoint`` serves a reference training checkpoint
  (``.pth``, or the JAX package's ``.npz`` pair) with the reference's
  architecture (``models/reference_model.py``);
- ``predict`` takes a path, a list of paths or a directory: probe and
  content box → ``ClipDataset`` (C++ decode of the letterbox content rows)
  → ``ClipLoader`` → ``device_feed`` → the serving forward → result dicts;
- ``evaluate`` predicts a labelled set and scores it;
- ``predict_sliding`` decodes each frame of a long video once and gathers
  the overlapping windows on the device, all in one batch;
- ``display_results`` renders ANSI probability bars.

The forward is K1 (``eval_preprocess``) → ConvNeXt with K2 and K3 in every
block → bi-GRU → classifier MLP → softmax; or, for a ViViT backbone, K1 →
patch embedding → spatial blocks (K4 with ``attention_impl="flash"``) →
temporal blocks → head → softmax.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from vision_collision_detection_tpu_torch.ckpt.checkpoint import (
    ARRAYS_FILE,
    CheckpointStore,
    load_checkpoint,
)
from vision_collision_detection_tpu_torch.config import ExperimentConfig
from vision_collision_detection_tpu_torch.data.datasets import (
    ClipDataset,
    ClipRecord,
)
from vision_collision_detection_tpu_torch.data.loader import (
    ClipLoader,
    device_feed,
)
from vision_collision_detection_tpu_torch.media.decoder import (
    MediaError,
    decode_frames,
    probe,
)
from vision_collision_detection_tpu_torch.metrics.classification import (
    classification_metrics,
)
from vision_collision_detection_tpu_torch.models import build_model
from vision_collision_detection_tpu_torch.ops.letterbox import (
    letterbox_geometry,
)
from vision_collision_detection_tpu_torch.ops.preprocess import eval_preprocess
from vision_collision_detection_tpu_torch.utils.device import resolve_device

VIDEO_EXTENSIONS = (".mp4", ".mov", ".MP4", ".MOV")
# predict_sliding pads the unique-frame pool and the windows to multiples
# of these, so that videos of other lengths run the same shapes
POOL_BUCKET = 64
WINDOW_BUCKET = 8


def sliding_windows(num_frames: int, fps: float, duration: float, T: int,
                    stride_sec: float, max_windows: int):
    """The windows of ``predict_sliding`` over a video of ``num_frames`` at
    ``fps``: a window starts every ``stride_sec`` (at most
    ``max_windows``), spans ``duration`` seconds of native frames, and
    takes T frames spread evenly inside them. → (starts, native frames a
    window, frame indices int64 [W, T])."""
    stride_frames = max(1, int(round(stride_sec * fps)))
    native_per_window = int(round(duration * fps))
    starts = list(range(
        0, max(1, num_frames - native_per_window + 1), stride_frames
    ))[:max_windows]
    indices = np.stack([
        np.linspace(s, min(s + native_per_window - 1, num_frames - 1), T
                    ).astype(np.int64)
        for s in starts
    ])
    return starts, native_per_window, indices


def fold_stride(cfg: ExperimentConfig) -> int:
    """The stride the decoder may keep frames at because the model would
    subsample them anyway. A ViViT never subsamples, so its stride is 1:
    the JAX predictor folds by ``frame_subsample`` for every backbone,
    which hands a ViViT half the frames its unfolded forward sees."""
    m = cfg.model
    T = cfg.data.num_frames
    if m.backbone.startswith("vivit"):
        return 1
    if m.frame_subsample > 1 and T > m.subsample_threshold:
        return m.frame_subsample
    return 1


class ServingForward(torch.nn.Module):
    """uint8 frames [B, T, ch, cw, 3] on the model's device → K1
    (``eval_preprocess``) → ``model`` → softmax, float32 [B, C]: the
    program the predictor serves and a serving bundle exports
    (``infer/aot.py``). A content-sized batch takes K1 on every device
    (its plain version on the CPU), so that a bundle and the forward it
    was exported from are one program on the CPU as on the card."""

    def __init__(self, model: torch.nn.Module, cfg: ExperimentConfig):
        super().__init__()
        self.model = model
        self.augment = cfg.augment
        self.frame_size = cfg.data.frame_size
        self.dtype = getattr(torch, cfg.model.dtype)

    def forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        x = eval_preprocess(frames_u8, self.augment, self.frame_size,
                            self.dtype, use_kernel="force")
        return torch.softmax(self.model(x).to(torch.float32), dim=-1)


class CollisionPredictor:
    def __init__(self, cfg: ExperimentConfig,
                 state_dict: Optional[Mapping[str, torch.Tensor]],
                 device=None, dwconv_kernel=None, fused_mlp=None,
                 model_override: Optional[torch.nn.Module] = None):
        """``state_dict``: the model's weights (``models.convert`` bridges a
        flax tree into one), or None to keep the seeded initial weights.
        ``device`` defaults to the card. ``dwconv_kernel``/``fused_mlp``
        override the ConvNeXt blocks' switches (None: the module default).
        ``model_override``: a ready model to serve instead of
        ``build_model(cfg.model)`` (``from_torch_checkpoint`` passes the
        reference's architecture), moved to ``device`` in eval mode."""
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        if model_override is not None:
            self.model = model_override.to(self.device).eval()
        else:
            self.model = build_model(cfg.model, device=self.device,
                                     dwconv_kernel=dwconv_kernel,
                                     fused_mlp=fused_mlp,
                                     frame_size=cfg.data.frame_size)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.class_names = tuple(cfg.data.class_names)
        self._forward_cache: Dict[object, object] = {}

    def serving_module(self, folded_stride: bool) -> ServingForward:
        """The ``ServingForward`` of this predictor's model. With
        ``folded_stride`` the decoder already kept every k-th frame (k =
        model.frame_subsample), so the model's own subsample is off; the
        parameters are shared."""
        key = ("module", bool(folded_stride))
        if key not in self._forward_cache:
            model = self.model
            if folded_stride:
                model = copy.copy(model)  # shares parameters and submodules
                model.frame_subsample = 1
            self._forward_cache[key] = ServingForward(model, self.cfg).eval()
        return self._forward_cache[key]

    def _make_forward(self, folded_stride: bool):
        """uint8 frames [B, T, ch, cw, 3] (tensor or array) → probs [B, C]
        float32 on the predictor's device, through ``serving_module``."""
        key = bool(folded_stride)
        if key in self._forward_cache:
            return self._forward_cache[key]
        module = self.serving_module(folded_stride)
        device = self.device

        @torch.inference_mode()
        def _forward(frames_u8):
            return module(torch.as_tensor(frames_u8).to(device,
                                                        non_blocking=True))

        self._forward_cache[key] = _forward
        return _forward

    def _make_sliding_forward(self):
        """(unique frames uint8 [U, S, S, 3], window indices int64 [W, T],
        both on the predictor's device) → probs [W, C]: the windows are
        gathered on the device from the pool of unique frames. The model
        subsamples the T frames itself (no folded stride)."""
        if "sliding" in self._forward_cache:
            return self._forward_cache["sliding"]

        module = self.serving_module(False)

        @torch.inference_mode()
        def fn(unique_u8, idx):
            windows = unique_u8.index_select(0, idx.reshape(-1))
            windows = windows.reshape(*idx.shape, *unique_u8.shape[1:])
            return module(windows)

        self._forward_cache["sliding"] = fn
        return fn

    def _sliding_forward(self, unique_u8, win_idx):
        """``unique_u8`` [U, S, S, 3] and ``win_idx`` [W, T] (arrays or
        tensors) → probs [W, C] on the device. U and W are padded to
        multiples of POOL_BUCKET and WINDOW_BUCKET (zero frames; windows of
        frame 0), and the padded windows' rows are dropped."""
        fn = self._make_sliding_forward()
        unique_u8 = torch.as_tensor(unique_u8)
        win_idx = torch.as_tensor(np.asarray(win_idx, np.int64))
        u, w = unique_u8.shape[0], win_idx.shape[0]
        pool = torch.zeros((-(-u // POOL_BUCKET) * POOL_BUCKET,
                            *unique_u8.shape[1:]),
                           dtype=torch.uint8, device=self.device)
        pool[:u].copy_(unique_u8)
        idx = torch.zeros((-(-w // WINDOW_BUCKET) * WINDOW_BUCKET,
                           win_idx.shape[1]),
                          dtype=torch.int64, device=self.device)
        idx[:w].copy_(win_idx)
        return fn(pool, idx)[:w]

    def _fold_stride(self) -> int:
        return fold_stride(self.cfg)

    def export_serving(self, out_dir: str, batch_sizes=(1, 8, 32),
                       content_box=None, platforms=None) -> dict:
        """Export this predictor's serving forward into a ``ServingBundle``
        directory (``infer/aot.py``): one ``torch.export`` program per batch
        bucket with the weights embedded, reloadable without model code."""
        from vision_collision_detection_tpu_torch.infer.aot import (
            export_bundle,
        )

        return export_bundle(self, out_dir, batch_sizes=batch_sizes,
                             content_box=content_box, platforms=platforms)

    def _content_box(self, sample_path: str):
        """Rectangular decode canvas = the letterbox content of this video:
        the decoder ships content rows only, and K1 pads the bars on the
        device."""
        info = probe(sample_path)
        S = self.cfg.data.frame_size
        nh, nw, _, _ = letterbox_geometry(info.height, info.width, S)
        # even sides, rounded up within the canvas
        return min(nh + nh % 2, S), min(nw + nw % 2, S)

    # ------------------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, path: str, device=None) -> "CollisionPredictor":
        """``path`` is a checkpoint directory (best/last/epoch_N) or a run
        directory, which resolves best → last → newest epoch. The weights
        load straight onto ``device`` (default: the card)."""
        ckpt_dir = cls._resolve(path)
        device = resolve_device(device)
        arrays, meta = load_checkpoint(ckpt_dir, map_location=device)
        if "hyperparams" not in meta:
            raise ValueError(f"{ckpt_dir} has no hyperparams contract")
        cfg = ExperimentConfig.from_dict(meta["hyperparams"])
        return cls(cfg, arrays["model"], device=device)

    @classmethod
    def from_torch_checkpoint(cls, path: str, dtype: str = "float32",
                              class_names=None, device=None,
                              dwconv_kernel=None, fused_mlp=None
                              ) -> "CollisionPredictor":
        """Serve a reference training checkpoint as the reference's own
        inference does: rebuild the architecture from its ``hyperparams``
        contract (``models.reference_model``) and load its
        ``model_state_dict``. ``path`` is a torch ``.pth`` (read with
        ``weights_only=False``: the reference's checkpoints hold more than
        tensors, so load only files you trust) or the ``.npz`` +
        ``.npz.hyperparams.json`` pair that the JAX package's
        ``cli.convert_weights --full`` writes. ``dtype`` is the model's
        compute dtype, ``device`` defaults to the card, and
        ``dwconv_kernel``/``fused_mlp`` are the ConvNeXt blocks' switches."""
        from vision_collision_detection_tpu_torch.models.convert import (
            load_flax_params,
            load_npz,
        )
        from vision_collision_detection_tpu_torch.models.import_torch import (
            convert_reference_checkpoint,
        )
        from vision_collision_detection_tpu_torch.models.reference_model import (
            build_reference_model,
        )

        if str(path).endswith(".npz"):
            variables = load_npz(path)
            with open(str(path) + ".hyperparams.json") as f:
                hp = json.load(f)
        else:
            ckpt = torch.load(path, map_location="cpu", weights_only=False)
            hp, variables = convert_reference_checkpoint(ckpt)
        model = build_reference_model(hp, dtype=dtype, device="cpu",
                                      dwconv_kernel=dwconv_kernel,
                                      fused_mlp=fused_mlp)
        load_flax_params(model, variables)
        overrides = {
            "model.backbone": model.backbone_name,
            "model.num_classes": model.num_classes,
            "data.num_classes": model.num_classes,
            "model.dtype": dtype,
            # the config's name for the reference's 'convolution'
            "model.temporal_mode": ("conv" if model.temporal_mode ==
                                    "convolution" else model.temporal_mode),
        }
        if class_names:
            overrides["data.class_names"] = tuple(class_names)
        elif model.num_classes != 3:
            overrides["data.class_names"] = tuple(
                f"class_{i}" for i in range(model.num_classes))
        cfg = ExperimentConfig().override(overrides)
        return cls(cfg, None, device=device, model_override=model)

    @staticmethod
    def _resolve(path: str) -> str:
        if os.path.isfile(os.path.join(path, ARRAYS_FILE)):
            return path
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint found under {path}")
        store = CheckpointStore(path)
        role = store.latest_role()
        if role is None:
            raise FileNotFoundError(f"no checkpoint found under {path}")
        return store.path(role)

    # ------------------------------------------------------------------
    def _collect_paths(self, videos: Union[str, Sequence[str]]) -> List[str]:
        if isinstance(videos, str):
            if os.path.isdir(videos):
                found = []
                for root, _, files in os.walk(videos):
                    for f in sorted(files):
                        if f.endswith(VIDEO_EXTENSIONS):
                            found.append(os.path.join(root, f))
                return found
            return [videos]
        return list(videos)

    def predict(
        self,
        videos: Union[str, Sequence[str]],
        sample_strategy: str = "center",
        batch_size: int = 8,
        event_times: Optional[Sequence[float]] = None,
        num_workers: int = 8,
    ) -> List[Dict]:
        """→ one result dict per clip, in the order of the paths. A clip
        that does not decode gives ``success: False``; a media library that
        cannot be built raises."""
        paths = self._collect_paths(videos)
        if not paths:
            return []
        records = [
            ClipRecord(
                video_id=os.path.splitext(os.path.basename(p))[0],
                video_path=p, label=0,
                event_time_sec=(event_times[i] if event_times else None),
            )
            for i, p in enumerate(paths)
        ]
        dc = self.cfg.data
        stride = self._fold_stride()
        try:
            content_box = self._content_box(paths[0])
        except (MediaError, OSError, ValueError):  # an unreadable first clip
            content_box = None
        ds = ClipDataset(
            records, fps=dc.fps, duration=dc.duration,
            frame_size=dc.frame_size, sample_strategy=sample_strategy,
            class_names=self.class_names, frame_stride=stride,
            content_box=content_box, fast_resize=dc.fast_resize,
            lowres_decode=dc.lowres_decode,
        )
        loader = ClipLoader(ds, batch_size, num_workers=num_workers)
        path_by_id = {r.video_id: r.video_path for r in records}
        return self._predict_batches(loader, stride, path_by_id)

    def _predict_batches(self, loader, stride: int,
                         path_by_id: Mapping[str, str]) -> List[Dict]:
        """``predict``'s loop after the loader: the batches' frames go
        through ``device_feed`` and the forward (folded when ``stride`` >
        1); one result dict per clip. The host reads a batch's
        probabilities (a copy to pinned memory, waited for by its event)
        only after it has queued the next batch's forward, so the card does
        not wait between batches while the host issues work."""
        forward = self._make_forward(stride > 1)
        results: List[Dict] = []

        def emit(ids, errors, probs, event):
            if event is not None:
                event.synchronize()
            probs = probs.numpy()
            for i, vid in enumerate(ids):
                if errors[i]:
                    results.append({
                        "video_path": path_by_id.get(vid),
                        "id": vid,
                        "success": False,
                        "error": "decode failed",
                    })
                    continue
                p = probs[i]
                k = int(p.argmax())
                results.append({
                    "video_path": path_by_id.get(vid),
                    "id": vid,
                    "success": True,
                    "predicted_class": self.class_names[k],
                    "predicted_label": k,
                    "confidence": float(p[k]),
                    "probabilities": {
                        name: float(p[j])
                        for j, name in enumerate(self.class_names)
                    },
                })

        pending = None
        for batch in device_feed(iter(loader), self.device, keys=("frames",)):
            probs = forward(batch["frames"])
            event = None
            if probs.is_cuda:
                host = torch.empty(probs.shape, dtype=probs.dtype,
                                   pin_memory=True)
                host.copy_(probs, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                probs = host
            if pending is not None:
                emit(*pending)
            pending = (batch["id"], batch["error"], probs, event)
        if pending is not None:
            emit(*pending)
        return results

    # ------------------------------------------------------------------
    def evaluate(
        self,
        metadata_df,
        *,
        video_path_column: str = "video_path",
        label_column: str = "video_type",
        sample_strategy: str = "center",
        batch_size: int = 8,
        confusion_matrix_path: str = "",
    ) -> dict:
        """Predict a labelled set and score it: accuracy, per-class P/R/F1,
        the weighted one-vs-rest AUC and the confusion matrix (rendered to
        a PNG when ``confusion_matrix_path`` is given). ``metadata_df`` is a
        DataFrame or a dict of columns; labels are class names or
        indices. ``num_failed`` counts the clips that did not decode."""
        name_to_idx = {n: i for i, n in enumerate(self.class_names)}
        paths = list(metadata_df[video_path_column])
        labels = [
            int(l) if isinstance(l, (int, np.integer)) else name_to_idx[l]
            for l in metadata_df[label_column]
        ]
        results = self.predict(paths, sample_strategy=sample_strategy,
                               batch_size=batch_size)
        ok = [i for i, r in enumerate(results) if r.get("success")]
        y_true = np.asarray([labels[i] for i in ok])
        y_pred = np.asarray([results[i]["predicted_label"] for i in ok])
        probs = np.asarray([
            [results[i]["probabilities"][n] for n in self.class_names]
            for i in ok
        ])
        metrics = classification_metrics(
            y_true, y_pred, probs, len(self.class_names), self.class_names
        )
        metrics["num_failed"] = len(results) - len(ok)
        if confusion_matrix_path:
            from vision_collision_detection_tpu_torch.obs.plots import (
                plot_confusion_matrix,
            )

            plot_confusion_matrix(
                metrics["confusion_matrix"], self.class_names,
                confusion_matrix_path,
            )
        return metrics

    # ------------------------------------------------------------------
    def predict_sliding(
        self,
        video_path: str,
        stride_sec: float = 1.0,
        max_windows: int = 64,
    ) -> List[Dict]:
        """Sliding-window inference over one long video: every window is a
        row of one batched forward. Each frame that a window needs is
        decoded once; the windows are gathered on the device."""
        info = probe(video_path)
        dc = self.cfg.data
        starts, native_per_window, all_indices = sliding_windows(
            info.num_frames, info.fps, dc.duration, dc.num_frames,
            stride_sec, max_windows)
        flat = np.unique(all_indices)
        decoded = decode_frames(
            video_path, flat, target_size=dc.frame_size, letterbox=True,
            fast_resize=dc.fast_resize, lowres=dc.lowres_decode,
        )
        win_idx = np.searchsorted(flat, all_indices)  # positions in flat
        probs = self._sliding_forward(decoded, win_idx).cpu().numpy()
        out = []
        for w, (s, p) in enumerate(zip(starts, probs)):
            k = int(p.argmax())
            out.append({
                "window": w,
                "start_sec": s / info.fps,
                "end_sec": min((s + native_per_window) / info.fps,
                               info.duration),
                "predicted_class": self.class_names[k],
                "confidence": float(p[k]),
                "probabilities": {
                    name: float(p[j]) for j, name in enumerate(self.class_names)
                },
            })
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def display_results(results: List[Dict], width: int = 40) -> str:
        """ANSI bar chart per clip; returns the text."""
        lines = []
        for r in results:
            name = r.get("id") or os.path.basename(r.get("video_path", "?"))
            if not r.get("success", True):
                lines.append(f"{name}: ERROR ({r.get('error')})")
                continue
            lines.append(f"{name}: {r['predicted_class']} "
                         f"({r['confidence'] * 100:.1f}%)")
            for cls, p in r["probabilities"].items():
                bar = "█" * int(p * width)
                lines.append(f"  {cls:<15} {bar:<{width}} {p * 100:5.1f}%")
        text = "\n".join(lines)
        print(text)
        return text
