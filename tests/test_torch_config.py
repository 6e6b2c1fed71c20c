"""The port's config tree keeps the JAX package's JSON contract: a config
written by either package reads back in the other with equal results."""

import dataclasses
import json

import pytest

from vision_collision_detection_tpu import config as jcfg
from vision_collision_detection_tpu_torch import CLASS_NAMES, CLASS_TO_INDEX
from vision_collision_detection_tpu_torch import config as tcfg

OVERRIDES = [
    {},
    {"model.backbone": "convnext_base", "data.frame_size": 160,
     "model.gelu_approximate": False, "data.class_names": ("a", "b", "c")},
    {"model.temporal_mode": "attention", "optim.learning_rate": 3e-4,
     "augment.rotation_range": (-3.0, 3.0), "video_dirs": ("x", "y")},
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_json_round_trips_across_packages(overrides):
    j = jcfg.ExperimentConfig().override(overrides)
    t = tcfg.ExperimentConfig().override(overrides)
    assert j.to_dict() == t.to_dict()
    assert json.loads(j.to_json()) == json.loads(t.to_json())
    assert tcfg.ExperimentConfig.from_json(j.to_json()).to_dict() == j.to_dict()
    assert jcfg.ExperimentConfig.from_json(t.to_json()).to_dict() == t.to_dict()


def test_same_fields_and_defaults():
    def walk(a, b):
        fa = {f.name: f for f in dataclasses.fields(a)}
        fb = {f.name: f for f in dataclasses.fields(b)}
        assert fa.keys() == fb.keys()
        for name in fa:
            va, vb = getattr(a, name), getattr(b, name)
            if dataclasses.is_dataclass(va):
                walk(va, vb)
            else:
                assert va == vb, name

    walk(jcfg.ExperimentConfig(), tcfg.ExperimentConfig())
    assert tcfg.ExperimentConfig().data.num_frames == 50


def test_old_checkpoint_config_gets_erf_gelu():
    d = tcfg.ExperimentConfig().to_dict()
    del d["model"]["gelu_approximate"]
    t = tcfg.ExperimentConfig.from_dict(d)
    j = jcfg.ExperimentConfig.from_dict(d)
    assert t.model.gelu_approximate is False
    assert t.to_dict() == j.to_dict()


@pytest.mark.parametrize("overrides", [
    {"model.backbone": "nope"},
    {"model.temporal_mode": "nope"},
    {"data.sample_strategy": "nope"},
    {"data.num_classes": 4},
    {"model.attention_impl": "nope"},
    {"data.lowres_decode": 4},
    {"augment.rotation_range": (-40.0, 40.0),
     "augment.shear_range": (-10.0, 10.0)},
])
def test_validate_rejects_what_the_jax_package_rejects(overrides):
    with pytest.raises(ValueError):
        jcfg.ExperimentConfig().override(overrides)
    with pytest.raises(ValueError):
        tcfg.ExperimentConfig().override(overrides)


def test_feature_dim_from_port_registry():
    assert tcfg.ModelConfig().backbone_feature_dim() == 768
    assert (tcfg.ModelConfig(backbone="convnext_large").backbone_feature_dim()
            == jcfg.ModelConfig(backbone="convnext_large").backbone_feature_dim())


def test_class_names():
    assert CLASS_NAMES == ("Normal", "Near Collision", "Collision")
    assert CLASS_TO_INDEX["Collision"] == 2


def _registries():
    from vision_collision_detection_tpu.utils.registry import (
        Registry as JaxRegistry,
    )
    from vision_collision_detection_tpu_torch.utils.registry import Registry

    out = []
    for cls in (JaxRegistry, Registry):
        reg = cls("head")
        for name, meta in (("gru", {"dim": 256, "recurrent": True}),
                           ("attention", {}), ("conv", {"kernel": 3})):
            reg.register(name, **meta)(lambda name=name: name)
        out.append(reg)
    return out


@pytest.mark.parametrize("query", ["names", "meta", "contains", "get",
                                   "twice", "unknown"])
def test_registry_matches_jax_registry(query):
    """The port's ``Registry`` answers as the JAX one on the same
    registrations: meta kept with each factory, names sorted, membership,
    ``get`` unchanged, and the same errors."""
    jax_reg, reg = _registries()
    if query == "names":
        assert reg.names() == jax_reg.names() == ["attention", "conv", "gru"]
    elif query == "meta":
        for name in jax_reg.names():
            assert reg.meta(name) == jax_reg.meta(name)
        assert reg.meta("gru") == {"dim": 256, "recurrent": True}
    elif query == "contains":
        for name in ("gru", "conv", "lstm", ""):
            assert (name in reg) == (name in jax_reg)
    elif query == "get":
        for name in jax_reg.names():
            assert reg.get(name)() == jax_reg.get(name)() == name
    else:
        errors = []
        for r in (jax_reg, reg):
            with pytest.raises(KeyError) as e:
                if query == "twice":
                    r.register("gru")(lambda: None)
                else:
                    r.get("lstm")
            errors.append(str(e.value))
        assert errors[0] == errors[1]


def test_backbone_registry_names_every_backbone():
    """Once each package has imported its families (``build_backbone``
    does), both registries hold the same ten names, none with meta."""
    from vision_collision_detection_tpu.models.backbones import (
        BACKBONE_REGISTRY as JAX_BACKBONES,
    )
    from vision_collision_detection_tpu.models.backbones import (  # noqa: F401
        convnext, efficientnet, mobilenet, resnet)
    from vision_collision_detection_tpu_torch.models.backbones import (
        BACKBONE_REGISTRY,
    )
    from vision_collision_detection_tpu_torch.models.backbones import (  # noqa: F401,E501
        convnext as _c, efficientnet as _e, mobilenet as _m, resnet as _r)

    assert BACKBONE_REGISTRY.names() == JAX_BACKBONES.names()
    assert len(BACKBONE_REGISTRY.names()) == 10
    assert all(BACKBONE_REGISTRY.meta(n) == JAX_BACKBONES.meta(n) == {}
               for n in BACKBONE_REGISTRY.names())
    assert "convnext_tiny" in BACKBONE_REGISTRY and "vgg" not in BACKBONE_REGISTRY
