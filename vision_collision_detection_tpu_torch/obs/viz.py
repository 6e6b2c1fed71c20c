"""Clip preview export and the attention view.

Counterpart of ``vision_collision_detection_tpu/obs/viz.py``:

- ``export_batch_preview``: a batch's clips as MP4s (the port's C++
  encoder, ``media.decoder.encode_video``) and an HTML grid page with the
  videos embedded as base64;
- ``extract_attention_weights``: the forward of a model with an attention
  head, and the temporal attention matrix that head kept, whole or as the
  importance of each frame; ``render_attention_overlay`` and
  ``plot_attention_heatmap`` draw it;
- ``render_result_card`` and ``browse_results``: a matplotlib card per
  prediction result, behind an ipywidgets selector where there is one.

matplotlib, ipywidgets and IPython are imported inside the functions, so
this module imports where none of them is installed.
"""

from __future__ import annotations

import base64
import html as html_mod
import os
from typing import Dict, List

import numpy as np
import torch

from vision_collision_detection_tpu_torch.media.decoder import encode_video


def denormalize_frames(frames: np.ndarray, mean, std) -> np.ndarray:
    """normalized float [..., H, W, 3] → uint8."""
    x = np.asarray(frames, np.float32)
    x = x * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def export_batch_preview(
    batch: Dict,
    out_dir: str,
    fps: float = 10.0,
    max_clips: int = 8,
    mean=(0.45,) * 3,
    std=(0.225,) * 3,
    html_name: str = "batch_preview.html",
) -> str:
    """Write per-clip MP4s + an HTML grid page; returns the HTML path."""
    os.makedirs(out_dir, exist_ok=True)
    frames = np.asarray(batch["frames"])
    n = min(frames.shape[0], max_clips)
    cells = []
    for i in range(n):
        clip = frames[i]
        if clip.dtype != np.uint8:
            clip = denormalize_frames(clip, mean, std)
        h, w = clip.shape[1:3]
        if h % 2 or w % 2:  # yuv420 needs even dims
            clip = clip[:, : h - h % 2, : w - w % 2]
        vid = batch.get("id", [f"clip{i}"] * n)[i]
        path = os.path.join(out_dir, f"preview_{i}_{vid}.mp4")
        encode_video(path, clip, fps=fps)
        with open(path, "rb") as f:
            b64 = base64.b64encode(f.read()).decode()
        label = ""
        if "target" in batch:
            label = f"target={int(np.asarray(batch['target'])[i])}"
        cells.append(
            f"<div class='cell'><video controls loop muted autoplay "
            f"src='data:video/mp4;base64,{b64}' width='240'></video>"
            f"<div>{html_mod.escape(str(vid))} {label}</div></div>"
        )
    doc = (
        "<html><head><style>body{font-family:monospace;background:#181818;"
        "color:#ddd}.grid{display:flex;flex-wrap:wrap;gap:12px}"
        ".cell{text-align:center}</style></head><body>"
        f"<h3>batch preview ({n} clips)</h3><div class='grid'>"
        + "".join(cells) + "</div></body></html>"
    )
    html_path = os.path.join(out_dir, html_name)
    with open(html_path, "w") as f:
        f.write(doc)
    return html_path


def extract_attention_weights(model: torch.nn.Module, frames: torch.Tensor,
                              per_frame: bool = True):
    """Run ``model`` on ``frames`` (eval mode, no grad; its mode restored
    afterwards) and take the temporal attention matrix its head kept.

    → (logits, attn float32 numpy [B, H, T, T]), or with ``per_frame`` the
    importance of each frame [B, T]: the attention it received, averaged
    over heads and query positions. Each head's matrix is cleared before
    the forward, so no call returns one left by an earlier call. Raises
    ``ValueError`` for a model without an attention head (the heads that
    keep their matrix in ``last_attention_weights``: ``TemporalAttention``
    and the reference model's)."""
    heads = [m for m in model.modules()
             if hasattr(m, "last_attention_weights")]
    for head in heads:
        head.last_attention_weights = None
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            logits = model(frames)
    finally:
        model.train(was_training)
    kept = [h.last_attention_weights for h in heads
            if h.last_attention_weights is not None]
    if not kept:
        raise ValueError(
            "model has no attention head (temporal_mode='attention' required)"
        )
    attn = kept[0].float().cpu().numpy()
    if not per_frame:
        return logits, attn
    return logits, attn.mean(axis=(1, 2))  # [B, T]


def _overlay_frames(frames_u8: np.ndarray, weights: np.ndarray,
                    bar_height: int = 8) -> np.ndarray:
    """The overlay's frames, uint8 [T, H, W, 3]: each frame's brightness
    scaled toward its min-max normalised weight, and a bottom bar whose
    filled width shows it."""
    frames = np.asarray(frames_u8)
    t = frames.shape[0]
    w_norm = np.asarray(weights, np.float32)
    w_norm = (w_norm - w_norm.min()) / max(
        float(w_norm.max() - w_norm.min()), 1e-8
    )
    out = frames.astype(np.float32).copy()
    for i in range(t):
        out[i] *= 0.4 + 0.6 * w_norm[i]
        fill = int(w_norm[i] * frames.shape[2])
        out[i, -bar_height:, :fill] = (255, 64, 64)
    return np.clip(out, 0, 255).astype(np.uint8)


def render_attention_overlay(
    frames_u8: np.ndarray,
    weights: np.ndarray,
    out_path: str,
    fps: float = 10.0,
    bar_height: int = 8,
) -> str:
    """Overlay per-frame attention onto a clip (``_overlay_frames``),
    cropped to even sides, and write it as an MP4; returns ``out_path``."""
    out = _overlay_frames(frames_u8, weights, bar_height)
    h, w = out.shape[1:3]
    out = out[:, : h - h % 2, : w - w % 2]
    encode_video(out_path, out, fps=fps)
    return out_path


def plot_attention_heatmap(attn: np.ndarray, out_path: str,
                           clip_index: int = 0) -> str:
    """[B, H, T, T] attention → per-head heatmap PNG; returns
    ``out_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a = np.asarray(attn)[clip_index]  # [H, T, T]
    n_heads = a.shape[0]
    fig, axes = plt.subplots(1, n_heads, figsize=(3.2 * n_heads, 3))
    if n_heads == 1:
        axes = [axes]
    for h, ax in enumerate(axes):
        im = ax.imshow(a[h], cmap="viridis")
        ax.set_title(f"head {h}")
        ax.set_xlabel("key frame")
        if h == 0:
            ax.set_ylabel("query frame")
    fig.colorbar(im, ax=axes[-1] if n_heads > 1 else axes[0])
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


# Result cards: one matplotlib "analysis card" per prediction result, and a
# notebook browser over them. Without ipywidgets the browser renders every
# card in turn; ``CollisionPredictor.display_results`` prints ANSI bars.

_CLASS_COLORS = {
    "Normal": "#4CAF50",
    "Near Collision": "#FF9800",
    "Collision": "#F44336",
}


def render_result_card(result: Dict, ax=None, show: bool = False):
    """One matplotlib card for a prediction result dict: the predicted
    class and a bar per class probability, or the error of a failed clip.
    Returns the matplotlib Figure (caller may save or display it)."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import patches

    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 4.5))
    else:
        fig = ax.figure
    ax.set_facecolor("#F5F5F5")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.axis("off")

    if not result.get("success", True):
        ax.text(0.5, 0.5, f"ERROR: {result.get('error', 'unknown')}",
                ha="center", fontsize=13, color="#F44336")
        return fig

    ax.text(0.5, 0.9, "Video Analysis Results", ha="center",
            fontsize=15, fontweight="bold")
    pred = result["predicted_class"]
    ax.text(0.5, 0.8, f"Predicted: {pred}", ha="center", fontsize=13,
            fontweight="bold", color=_CLASS_COLORS.get(pred, "#333333"))

    ranked = sorted(result["probabilities"].items(), key=lambda kv: -kv[1])
    y = 0.64
    for cls, p in ranked:
        color = _CLASS_COLORS.get(cls, "#999999")
        ax.add_patch(patches.Rectangle((0.22, y - 0.04), 0.6, 0.08,
                                       facecolor="#E0E0E0", alpha=0.5))
        ax.add_patch(patches.Rectangle((0.22, y - 0.04),
                                       max(0.01, p * 0.6), 0.08,
                                       facecolor=color))
        ax.text(0.20, y, cls, ha="right", va="center", fontsize=10,
                fontweight="bold")
        ax.text(0.84, y, f"{p * 100:.1f}%", ha="left", va="center",
                fontsize=10)
        y -= 0.14

    meta = []
    if result.get("video_path"):
        meta.append(f"File: {os.path.basename(result['video_path'])}")
    if result.get("id"):
        meta.append(f"id: {result['id']}")
    if meta:
        ax.text(0.5, 0.08, " | ".join(meta), ha="center", fontsize=8,
                color="#666666")
    return fig


def browse_results(results: List[Dict]):
    """Notebook browser over prediction results: an ipywidgets dropdown
    selects the clip and its card re-renders on change. Without ipywidgets
    (or IPython) every card is rendered in turn instead.

    Returns the widget container, or the list of figures without
    ipywidgets."""
    try:
        import ipywidgets as widgets
        from IPython.display import display
    except ImportError:
        return [render_result_card(r, show=True) for r in results]

    import matplotlib.pyplot as plt

    names = [
        r.get("id") or os.path.basename(r.get("video_path", f"clip {i}"))
        for i, r in enumerate(results)
    ]
    dd = widgets.Dropdown(options=list(zip(names, range(len(results)))),
                          description="clip")
    out = widgets.Output()

    def _render(idx: int) -> None:
        with out:
            out.clear_output(wait=True)
            fig = render_result_card(results[idx], show=True)
            display(fig)
            plt.close(fig)

    dd.observe(lambda ch: _render(ch["new"]), names="value")
    box = widgets.VBox([dd, out])
    display(box)
    _render(0)
    return box
