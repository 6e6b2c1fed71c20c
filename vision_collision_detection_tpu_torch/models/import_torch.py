"""Reference checkpoints (torch ``EnhancedFrameCNN``) into the port.

Counterpart of the JAX package's ``models/import_torch.py`` and of the
torchvision converters of its ``models/convert.py``. A reference
checkpoint is a dict with ``model_state_dict`` (torchvision key names under
``backbone.``, the head under ``temporal_aggregation.``, the classifier
under ``classifier.``) and a ``hyperparams`` contract.
``convert_reference_checkpoint`` turns one into the flax variables tree of
``ReferenceVideoClassifier`` ({"params", "batch_stats"} of numpy arrays,
the tree the JAX package's ``cli.convert_weights --full`` saves as
``.npz``), which ``models.convert.load_flax_params`` loads into the port's
model. The port's modules keep the JAX modules' tree, so both steps are
key maps with transposes; the ConvNeXt keeps K2's [49, C] depthwise layout.

Gate and bias folds (where a wrong one silently moves the logits):
- torch's GRU packs (r, z, n); flax's ``hr``/``hz`` have no bias, so
  torch's b_hr and b_hz fold into ``ir``/``iz``; b_in and b_hn stay apart,
  since r multiplies only the hidden side: n = tanh(W_in·x + b_in +
  r⊙(W_hn·h + b_hn));
- torch's LSTM packs (i, f, g, o); flax's input kernels have no bias, so
  b_ih + b_hh fold into the ``h*`` biases;
- torch's RNN: both biases fold into flax's ``i`` bias.

The torchvision layouts are checked against the manifests copied into
``models/manifests/`` (key → shape of every parameter and buffer of the ten
backbones).
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np

MANIFEST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "manifests")


def _t(x) -> np.ndarray:
    try:  # a torch tensor
        return x.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(x)


def _conv(sd, name):
    # Conv2d [O, I, kh, kw] → flax [kh, kw, I, O]; depthwise [C, 1, kh, kw]
    # → [kh, kw, 1, C] by the same transpose
    return np.transpose(_t(sd[f"{name}.weight"]), (2, 3, 1, 0))


def _conv1d(sd, name):
    # Conv1d [O, I, k] → flax [k, I, O]
    return {"kernel": np.transpose(_t(sd[f"{name}.weight"]), (2, 1, 0)),
            "bias": _t(sd[f"{name}.bias"])}


def _linear(sd, name):
    return {"kernel": _t(sd[f"{name}.weight"]).T,
            "bias": _t(sd[f"{name}.bias"])}


def _bn(sd, name) -> Tuple[dict, dict]:
    return ({"scale": _t(sd[f"{name}.weight"]),
             "bias": _t(sd[f"{name}.bias"])},
            {"mean": _t(sd[f"{name}.running_mean"]),
             "var": _t(sd[f"{name}.running_var"])})


def _ln(sd, name):
    return {"scale": _t(sd[f"{name}.weight"]), "bias": _t(sd[f"{name}.bias"])}


def _subdict(sd: Dict, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# Backbones (torchvision names → the JAX modules' tree)
# ---------------------------------------------------------------------------
def convert_resnet(sd: Dict, stage_sizes, bottleneck: bool) -> Dict:
    params: Dict = {"stem_conv": {"kernel": _conv(sd, "conv1")}}
    stats: Dict = {}
    params["stem_bn"], stats["stem_bn"] = _bn(sd, "bn1")
    for stage, blocks in enumerate(stage_sizes):
        for b in range(blocks):
            src, dst = f"layer{stage + 1}.{b}", f"layer{stage + 1}_{b}"
            p: Dict = {}
            st: Dict = {}
            for c in range(1, (3 if bottleneck else 2) + 1):
                p[f"conv{c}"] = {"kernel": _conv(sd, f"{src}.conv{c}")}
                p[f"bn{c}"], st[f"bn{c}"] = _bn(sd, f"{src}.bn{c}")
            if f"{src}.downsample.0.weight" in sd:
                p["downsample_conv"] = {
                    "kernel": _conv(sd, f"{src}.downsample.0")}
                p["downsample_bn"], st["downsample_bn"] = _bn(
                    sd, f"{src}.downsample.1")
            params[dst], stats[dst] = p, st
    return {"params": params, "batch_stats": stats}


def convert_convnext(sd: Dict, depths) -> Dict:
    params: Dict = {
        "stem_conv": {"kernel": _conv(sd, "features.0.0"),
                      "bias": _t(sd["features.0.0.bias"])},
        "stem_norm": _ln(sd, "features.0.1")}
    for stage in range(len(depths)):
        feat = 1 + 2 * stage  # the stages sit at features.1, 3, 5, 7
        if stage > 0:
            ds = f"features.{feat - 1}"
            params[f"downsample{stage}_norm"] = _ln(sd, f"{ds}.0")
            params[f"downsample{stage}_conv"] = {
                "kernel": _conv(sd, f"{ds}.1"), "bias": _t(sd[f"{ds}.1.bias"])}
        for b in range(depths[stage]):
            src = f"features.{feat}.{b}.block"
            params[f"stage{stage}_block{b}"] = {
                "dwconv": {"kernel": _conv(sd, f"{src}.0"),
                           "bias": _t(sd[f"{src}.0.bias"])},
                "norm": _ln(sd, f"{src}.2"),
                "pwconv1": _linear(sd, f"{src}.3"),
                "pwconv2": _linear(sd, f"{src}.5"),
                "gamma": _t(sd[f"features.{feat}.{b}.layer_scale"]).reshape(-1),
            }
    # torchvision's classifier.0 is the LayerNorm2d before the fc
    if "classifier.0.weight" in sd:
        params["head_norm"] = _ln(sd, "classifier.0")
    return {"params": params, "batch_stats": {}}


def convert_mobilenet_v2(sd: Dict) -> Dict:
    from vision_collision_detection_tpu_torch.models.backbones.mobilenet import (
        _V2_TABLE,
    )

    params: Dict = {"stem_conv": {"kernel": _conv(sd, "features.0.0")}}
    stats: Dict = {}
    params["stem_bn"], stats["stem_bn"] = _bn(sd, "features.0.1")
    feat, blk = 1, 0
    for t, _, n, _ in _V2_TABLE:
        for _ in range(n):
            src = f"features.{feat}.conv"
            p: Dict = {}
            st: Dict = {}
            if t == 1:  # no expand: conv.0 the depthwise, conv.1/2 project
                layers = (("dw", f"{src}.0.0", f"{src}.0.1"),
                          ("project", f"{src}.1", f"{src}.2"))
            else:
                layers = (("expand", f"{src}.0.0", f"{src}.0.1"),
                          ("dw", f"{src}.1.0", f"{src}.1.1"),
                          ("project", f"{src}.2", f"{src}.3"))
            for name, conv, bn in layers:
                p[f"{name}_conv"] = {"kernel": _conv(sd, conv)}
                p[f"{name}_bn"], st[f"{name}_bn"] = _bn(sd, bn)
            params[f"block{blk}"], stats[f"block{blk}"] = p, st
            feat, blk = feat + 1, blk + 1
    params["head_conv"] = {"kernel": _conv(sd, f"features.{feat}.0")}
    params["head_bn"], stats["head_bn"] = _bn(sd, f"features.{feat}.1")
    return {"params": params, "batch_stats": stats}


def _se(sd, src):
    return {"fc1": {"kernel": _conv(sd, f"{src}.fc1"),
                    "bias": _t(sd[f"{src}.fc1.bias"])},
            "fc2": {"kernel": _conv(sd, f"{src}.fc2"),
                    "bias": _t(sd[f"{src}.fc2.bias"])}}


def convert_efficientnet_v2(sd: Dict, table) -> Dict:
    params: Dict = {"stem_conv": {"kernel": _conv(sd, "features.0.0")}}
    stats: Dict = {}
    params["stem_bn"], stats["stem_bn"] = _bn(sd, "features.0.1")
    blk = 0
    for stage, (kind, expand, _, _, _, repeats) in enumerate(table, start=1):
        for i in range(repeats):
            src = f"features.{stage}.{i}.block"
            p: Dict = {}
            st: Dict = {}
            if kind == "fused" and expand == 1:
                layers = (("project", f"{src}.0"),)
            elif kind == "fused":
                layers = (("expand", f"{src}.0"), ("project", f"{src}.1"))
            else:  # MBConv with SE at block.2
                layers = (("expand", f"{src}.0"), ("dw", f"{src}.1"),
                          ("project", f"{src}.3"))
                p["se"] = _se(sd, f"{src}.2")
            for name, at in layers:
                p[f"{name}_conv"] = {"kernel": _conv(sd, f"{at}.0")}
                p[f"{name}_bn"], st[f"{name}_bn"] = _bn(sd, f"{at}.1")
            params[f"block{blk}"], stats[f"block{blk}"] = p, st
            blk += 1
    head = f"features.{len(table) + 1}"
    params["head_conv"] = {"kernel": _conv(sd, f"{head}.0")}
    params["head_bn"], stats["head_bn"] = _bn(sd, f"{head}.1")
    return {"params": params, "batch_stats": stats}


def convert_mobilenet_v3_small(sd: Dict) -> Dict:
    from vision_collision_detection_tpu_torch.models.backbones.mobilenet import (
        _V3_SMALL_TABLE,
    )

    params: Dict = {"stem_conv": {"kernel": _conv(sd, "features.0.0")}}
    stats: Dict = {}
    params["stem_bn"], stats["stem_bn"] = _bn(sd, "features.0.1")
    cin = 16
    for blk, (_, exp, out, use_se, _, _) in enumerate(_V3_SMALL_TABLE):
        src = f"features.{blk + 1}.block"
        p: Dict = {}
        st: Dict = {}
        li = 0
        if exp != cin:
            p["expand_conv"] = {"kernel": _conv(sd, f"{src}.{li}.0")}
            p["expand_bn"], st["expand_bn"] = _bn(sd, f"{src}.{li}.1")
            li += 1
        p["dw_conv"] = {"kernel": _conv(sd, f"{src}.{li}.0")}
        p["dw_bn"], st["dw_bn"] = _bn(sd, f"{src}.{li}.1")
        li += 1
        if use_se:
            p["se"] = _se(sd, f"{src}.{li}")
            li += 1
        p["project_conv"] = {"kernel": _conv(sd, f"{src}.{li}.0")}
        p["project_bn"], st["project_bn"] = _bn(sd, f"{src}.{li}.1")
        params[f"block{blk}"], stats[f"block{blk}"] = p, st
        cin = out
    head = len(_V3_SMALL_TABLE) + 1
    params["head_conv"] = {"kernel": _conv(sd, f"features.{head}.0")}
    params["head_bn"], stats["head_bn"] = _bn(sd, f"features.{head}.1")
    return {"params": params, "batch_stats": stats}


def _effnet(name):
    from vision_collision_detection_tpu_torch.models.backbones import (
        efficientnet,
    )

    table = {"efficientnet_v2_s": efficientnet._V2_S,
             "efficientnet_v2_m": efficientnet._V2_M,
             "efficientnet_v2_l": efficientnet._V2_L}[name][1]
    return lambda sd: convert_efficientnet_v2(sd, table)


_CONVERTERS = {
    "resnet18": lambda sd: convert_resnet(sd, (2, 2, 2, 2), False),
    "resnet50": lambda sd: convert_resnet(sd, (3, 4, 6, 3), True),
    "convnext_tiny": lambda sd: convert_convnext(sd, (3, 3, 9, 3)),
    "convnext_base": lambda sd: convert_convnext(sd, (3, 3, 27, 3)),
    "convnext_large": lambda sd: convert_convnext(sd, (3, 3, 27, 3)),
    "mobilenet_v2": convert_mobilenet_v2,
    "mobilenet_v3_small": convert_mobilenet_v3_small,
    "efficientnet_v2_s": _effnet("efficientnet_v2_s"),
    "efficientnet_v2_m": _effnet("efficientnet_v2_m"),
    "efficientnet_v2_l": _effnet("efficientnet_v2_l"),
}


def load_manifest(backbone: str) -> Dict[str, tuple]:
    with open(os.path.join(MANIFEST_DIR, f"{backbone}.json")) as f:
        return {k: tuple(v) for k, v in json.load(f)["keys"].items()}


def _head_or_buffer(backbone: str, key: str) -> bool:
    """Keys that may be absent or ignored: the ImageNet classification head
    (the reference strips it) and BatchNorm step counters."""
    if key.endswith("num_batches_tracked"):
        return True
    if backbone.startswith("convnext"):
        # classifier.0 is the feature path's LayerNorm2d; only the fc is head
        return key.startswith("classifier.2")
    return key.startswith("fc.") or key.startswith("classifier.")


def validate_state_dict(state_dict: Dict, backbone: str) -> None:
    """Check a torchvision ``state_dict`` against the manifest: missing or
    unexpected keys and shape mismatches raise ``ValueError``."""
    manifest = load_manifest(backbone)
    keys = set(state_dict)
    required = {k for k in manifest if not _head_or_buffer(backbone, k)}
    missing = sorted(required - keys)
    unexpected = sorted(k for k in keys - set(manifest)
                        if not _head_or_buffer(backbone, k))
    problems = []
    if missing:
        problems.append(f"{len(missing)} missing keys, e.g. {missing[:5]}")
    if unexpected:
        problems.append(
            f"{len(unexpected)} unexpected keys, e.g. {unexpected[:5]}")
    for k in sorted(required & keys):
        got = tuple(getattr(state_dict[k], "shape", ()))
        if got != manifest[k]:
            problems.append(f"shape mismatch at {k}: {got} vs "
                            f"torchvision {manifest[k]}")
            break
    if problems:
        raise ValueError(
            f"state_dict does not match the torchvision {backbone!r} "
            f"layout: " + "; ".join(problems) +
            ". Expected a torchvision classification checkpoint "
            "(layouts in models/manifests/).")


def convert_torch_state_dict(state_dict: Dict, backbone: str,
                             validate: bool = False) -> Dict:
    """torchvision ``state_dict`` → {"params", "batch_stats"} of the named
    backbone; ``validate`` checks it against the manifest first."""
    if backbone not in _CONVERTERS:
        raise NotImplementedError(
            f"no converter for {backbone!r}; available: {sorted(_CONVERTERS)}")
    if validate:
        validate_state_dict(state_dict, backbone)
    return _CONVERTERS[backbone](state_dict)


# ---------------------------------------------------------------------------
# Temporal heads and classifier
# ---------------------------------------------------------------------------
def convert_attention_head(sd: Dict) -> Dict:
    """``nn.MultiheadAttention``'s packed QKV → query/key/value/out."""
    w = _t(sd["attention.in_proj_weight"])  # [3D, D]
    b = _t(sd["attention.in_proj_bias"])
    d = w.shape[1]
    return {
        "norm": _ln(sd, "norm"),
        "pos_embedding": _t(sd["pos_encoder"])[0],  # [1, max, D] → [max, D]
        "query": {"kernel": w[:d].T, "bias": b[:d]},
        "key": {"kernel": w[d:2 * d].T, "bias": b[d:2 * d]},
        "value": {"kernel": w[2 * d:].T, "bias": b[2 * d:]},
        "out": _linear(sd, "attention.out_proj"),
    }


def convert_conv_head(sd: Dict) -> Tuple[Dict, Dict]:
    """``conv_block`` Sequential: convs at 0 and 3, BatchNorms at 1 and 4."""
    params: Dict = {"conv1": _conv1d(sd, "conv_block.0"),
                    "conv2": _conv1d(sd, "conv_block.3")}
    stats: Dict = {}
    params["bn1"], stats["bn1"] = _bn(sd, "conv_block.1")
    params["bn2"], stats["bn2"] = _bn(sd, "conv_block.4")
    return params, stats


def _split_gates(w: np.ndarray, n: int):
    h = w.shape[0] // n
    return [w[i * h:(i + 1) * h] for i in range(n)]


def _gru_cell(wi, wh, bi, bh) -> Dict:
    (w_ir, w_iz, w_in), (w_hr, w_hz, w_hn) = _split_gates(wi, 3), _split_gates(wh, 3)
    (b_ir, b_iz, b_in), (b_hr, b_hz, b_hn) = _split_gates(bi, 3), _split_gates(bh, 3)
    return {"ir": {"kernel": w_ir.T, "bias": b_ir + b_hr},
            "iz": {"kernel": w_iz.T, "bias": b_iz + b_hz},
            "in": {"kernel": w_in.T, "bias": b_in},
            "hr": {"kernel": w_hr.T},
            "hz": {"kernel": w_hz.T},
            "hn": {"kernel": w_hn.T, "bias": b_hn}}


def _lstm_cell(wi, wh, bi, bh) -> Dict:
    wi4, wh4 = _split_gates(wi, 4), _split_gates(wh, 4)
    bi4, bh4 = _split_gates(bi, 4), _split_gates(bh, 4)
    out: Dict = {}
    for idx, g in enumerate("ifgo"):
        out[f"i{g}"] = {"kernel": wi4[idx].T}
        out[f"h{g}"] = {"kernel": wh4[idx].T, "bias": bi4[idx] + bh4[idx]}
    return out


def _simple_cell(wi, wh, bi, bh) -> Dict:
    return {"i": {"kernel": wi.T, "bias": bi + bh}, "h": {"kernel": wh.T}}


_CELL_CONVERTERS = {"gru": _gru_cell, "lstm": _lstm_cell, "rnn": _simple_cell}


def convert_rnn_head(sd: Dict, cell_type: str, num_layers: int,
                     bidirectional: bool) -> Dict:
    """A stacked torch ``nn.RNN``/``LSTM``/``GRU`` → per-layer flax cells."""
    conv = _CELL_CONVERTERS[cell_type]
    params: Dict = {"norm": _ln(sd, "norm")}
    dirs = [("fw", "")] + ([("bw", "_reverse")] if bidirectional else [])
    for layer in range(num_layers):
        for dname, suffix in dirs:
            params[f"l{layer}_{dname}_cell"] = conv(*(
                _t(sd[f"rnn.{k}_l{layer}{suffix}"])
                for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))
    if "projection.weight" in sd:
        params["projection"] = _linear(sd, "projection")
    return params


def convert_classifier(sd: Dict) -> Tuple[Dict, Dict]:
    """The classifier Sequential: Linears at 0, 4, 8, BatchNorms at 1, 5."""
    params: Dict = {"fc1": _linear(sd, "0"), "fc2": _linear(sd, "4"),
                    "fc_out": _linear(sd, "8")}
    stats: Dict = {}
    params["bn1"], stats["bn1"] = _bn(sd, "1")
    params["bn2"], stats["bn2"] = _bn(sd, "5")
    return params, stats


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------
def derive_hyperparams(sd: Dict, hyperparams: Optional[Dict] = None) -> Dict:
    """The checkpoint's ``hyperparams`` contract merged with what the
    ``state_dict``'s shapes say (the shapes win where both speak)."""
    hp = dict(hyperparams or {})
    hp.setdefault("base_model", "convnext_tiny")

    head = _subdict(sd, "temporal_aggregation.")
    if "attention.in_proj_weight" in head:
        hp["temporal_mode"] = "attention"
        # the packed QKV hides the head count: only the contract says it.
        # A count that does not divide the width contradicts the shapes; a
        # missing one means the reference default of 4, which groups the
        # softmax wrongly (no shape error) if the checkpoint used another.
        d = _t(head["attention.in_proj_weight"]).shape[1]
        if "attention_heads" in hp:
            heads = int(hp["attention_heads"])
            if heads <= 0 or d % heads:
                raise ValueError(
                    f"checkpoint hyperparams claim attention_heads={heads}, "
                    f"but the attention embed dim is {d} (not divisible); "
                    f"the contract contradicts the state_dict shapes")
        else:
            warnings.warn(
                f"checkpoint hyperparams omit 'attention_heads'; assuming "
                f"the reference default of 4. If this checkpoint was "
                f"trained with a different head count the logits will be "
                f"silently wrong; pass hyperparams explicitly. (embed dim "
                f"{d})", stacklevel=2)
            hp["attention_heads"] = 4
            if d % 4:
                raise ValueError(
                    f"attention embed dim {d} is not divisible by the "
                    f"assumed default of 4 heads; 'attention_heads' must be "
                    f"supplied in hyperparams")
    elif "conv_block.0.weight" in head:
        hp["temporal_mode"] = "convolution"
    elif "rnn.weight_ih_l0" in head:
        h = _t(head["rnn.weight_hh_l0"]).shape[1]
        ratio = _t(head["rnn.weight_ih_l0"]).shape[0] // h
        # the gate ratio (3 gru, 4 lstm, 1 rnn) names the cell; the shapes
        # win over a stale contract
        hp["temporal_mode"] = {3: "gru", 4: "lstm", 1: "rnn"}[ratio]
        hp["rnn_hidden_dim"] = h
        hp["rnn_num_layers"] = 1 + max(
            int(k.split("_l")[-1].split("_")[0]) for k in head
            if k.startswith("rnn.weight_ih_l"))
        hp["rnn_bidirectional"] = any(k.endswith("_reverse") for k in head)
    else:
        hp.setdefault("temporal_mode", "pooling")

    if "classifier.8.weight" in sd:
        hp["num_classes"] = int(_t(sd["classifier.8.weight"]).shape[0])
    hp.setdefault("num_classes", 3)
    return hp


def convert_reference_checkpoint(checkpoint: Dict) -> Tuple[Dict, Dict]:
    """A reference training checkpoint (``model_state_dict`` and
    ``hyperparams``) or a bare ``state_dict`` → (hyperparams, variables
    ``{"params", "batch_stats"}`` of ``ReferenceVideoClassifier``). A DDP
    checkpoint's ``module.`` prefix is taken off."""
    if "model_state_dict" in checkpoint:
        sd = checkpoint["model_state_dict"]
        hp_in = checkpoint.get("hyperparams")
    else:
        sd, hp_in = checkpoint, None
    sd = dict(sd)
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):] if k.startswith("module.") else k: v
              for k, v in sd.items()}

    hp = derive_hyperparams(sd, hp_in)
    backbone = convert_torch_state_dict(_subdict(sd, "backbone."),
                                        hp["base_model"])
    params: Dict = {"backbone": backbone["params"]}
    stats: Dict = {}
    if backbone["batch_stats"]:
        stats["backbone"] = backbone["batch_stats"]

    head = _subdict(sd, "temporal_aggregation.")
    mode = hp["temporal_mode"]
    if mode == "attention":
        params["temporal"] = convert_attention_head(head)
    elif mode == "convolution":
        params["temporal"], stats["temporal"] = convert_conv_head(head)
    elif mode in _CELL_CONVERTERS:
        params["temporal"] = convert_rnn_head(
            head, mode, hp["rnn_num_layers"], hp["rnn_bidirectional"])
    # pooling: no parameters

    cls_params, cls_stats = convert_classifier(_subdict(sd, "classifier."))
    params.update(cls_params)
    stats.update(cls_stats)
    return hp, {"params": params, "batch_stats": stats}


def import_checkpoint_file(pth_path: str, out_path: Optional[str] = None
                           ) -> Tuple[Dict, Dict]:
    """A reference training checkpoint (``.pth``) → (hyperparams,
    variables); with ``out_path``, also written as the ``.npz`` and its
    ``.npz.hyperparams.json`` sidecar that
    ``CollisionPredictor.from_torch_checkpoint`` reads. The ``.pth`` is
    read with ``weights_only=False``: load only files you trust."""
    import torch

    from vision_collision_detection_tpu_torch.models.convert import save_npz

    ckpt = torch.load(pth_path, map_location="cpu", weights_only=False)
    hp, variables = convert_reference_checkpoint(ckpt)
    if out_path:
        save_npz(variables, out_path)
        with open(str(out_path) + ".hyperparams.json", "w") as f:
            json.dump(hp, f, indent=2)
    return hp, variables
