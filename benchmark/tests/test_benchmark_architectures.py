"""One module per architecture (``benchmark/architectures/``): a module the
repository does not have is reached by every shared function through the
configuration's ``"architecture"`` alone; no shared file names an
architecture; and the two modules read exactly what the harness read
before they were split out of the shared files."""

from __future__ import annotations

import hashlib
import re
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import architectures, counts, harness
from benchmark.architectures import convnext_gru, vivit
from benchmark.reference import models, weights

BENCH = Path(harness.__file__).resolve().parent
STUB = "stub_pool_mlp"


def stub_module() -> types.ModuleType:
    """An architecture the repository does not have: the frames' mean
    colour through one linear layer, a scale drawn by a law of its own, one
    extra launch counter."""
    m = types.ModuleType(f"benchmark.architectures.{STUB}")

    def param_spec(c):
        spec = []
        weights.linear_spec(spec, "head", 3, c["num_classes"])
        spec.append(("scale", (1,), ("stub_constant", 2.0)))
        return spec

    def logits(P, frames, c, prec, training, generator, ckpt):
        x = frames.mean(dim=(1, 2, 3))
        return P["scale"] * models.linear(prec, x, P, "head")

    m.param_spec = param_spec
    m.logits = logits
    m.clip_flops = lambda c, train: (2.0 * 3 * c["num_classes"], 6.0)
    m.frozen_mask = lambda name, c: None
    m.shrink = lambda c: dict(c, frames=2, program={"data.batch_size": 1})
    m.LAWS = {"stub_constant": lambda z, u, value: torch.full_like(z, value)}
    m.COUNTERS = {"stub_k1": ("ops.dequant_pad", "dequant_normalize_pad",
                              ("launches",))}
    return m


def test_a_new_architecture_needs_no_other_file(monkeypatch, shrunk):
    monkeypatch.setitem(sys.modules, f"benchmark.architectures.{STUB}",
                        stub_module())
    c = {"architecture": STUB, "num_classes": 3, "frames": 4}
    assert architectures.get(STUB) is sys.modules[f"benchmark.architectures.{STUB}"]
    spec = weights.param_spec(c)
    assert [n for n, _, _ in spec] == ["head.weight", "head.bias", "scale"]
    P = weights.make_params(c, 7, "cpu")
    assert P["head.weight"].shape == (3, 3) and float(P["scale"]) == 2.0
    assert counts.clip_flops(c, False) == 18.0
    assert counts.clip_flops(c, True) == 3 * 18.0 - 6.0
    frames = torch.rand(2, 4, 5, 5, 3, generator=torch.Generator().manual_seed(1))
    want = 2.0 * (frames.mean(dim=(1, 2, 3)) @ P["head.weight"].t()
                  + P["head.bias"])
    assert torch.allclose(models.logits(P, frames, c), want)
    w = shrunk({"c": dict(c), "t": {"kind": "train"}})
    assert w["c"]["frames"] == 2 and w["c"]["program"] == {"data.batch_size": 1}
    got = harness.counters(c)
    assert "stub_k1.launches" in got and "K4.launches" in got
    assert "device_feed.batches" in got


def test_a_missing_architecture_names_the_file_it_expected():
    with pytest.raises(ModuleNotFoundError, match=r"benchmark/architectures/"
                       r"no_such_model\.py"):
        architectures.get("no_such_model")
    with pytest.raises(ValueError, match="not a module name"):
        architectures.get("../vivit")


SHARED = sorted(
    [BENCH / f for f in ("harness.py", "counts.py", "readers.py", "serve.py",
                         "train.py", "control.py", "run.py", "trace.py",
                         "port_trace.py", "architectures/__init__.py",
                         "tests/conftest.py")]
    + list((BENCH / "reference").glob("*.py")))
ARCHITECTURES = sorted(p.stem for p in (BENCH / "architectures").glob("*.py")
                       if p.stem != "__init__")


def test_every_architecture_is_a_module():
    assert {"convnext_gru", "vivit"} <= set(ARCHITECTURES)
    for name in ARCHITECTURES:
        m = architectures.get(name)
        for fn in ("param_spec", "logits", "clip_flops", "frozen_mask",
                   "shrink"):
            assert callable(getattr(m, fn)), (name, fn)


@pytest.mark.parametrize("path", SHARED, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_shared_file_names_an_architecture(path):
    quoted = re.compile("['\"](%s)['\"]" % "|".join(ARCHITECTURES))
    found = [f"{i}: {line.strip()}" for i, line in
             enumerate(path.read_text().splitlines(), 1) if quoted.search(line)]
    assert not found, found


# ---- the readings of the parent harness, before the split --------------------------------

def digest(x) -> str:
    return hashlib.sha256(repr(x).encode()).hexdigest()[:16]


@pytest.fixture(scope="module")
def flagship():
    return harness.cell("flagship.serve")["c"]


@pytest.fixture(scope="module")
def vivit_small():
    return harness.cell("vivit_small.serve")["c"]


@pytest.mark.parametrize("cell,kind,flops", [
    ("flagship.serve", "serve", 222_817_594_368),
    ("flagship.serve", "train", 667_730_248_704),
    ("vivit_small.serve", "serve", 661_081_032_960),
    ("vivit_small.serve", "train", 1_974_919_502_592)])
def test_clip_flops_read_as_before(cell, kind, flops):
    c = harness.for_kind(harness.cell(cell)["c"], kind)
    assert counts.clip_flops(c, kind == "train") == flops


@pytest.mark.parametrize("cell,tensors,params,spec_digest", [
    ("flagship.serve", 196, 29_791_075, "185bc749b0122370"),
    ("vivit_small.serve", 202, 21_768_195, "0c33e9b04f98900b")])
def test_param_spec_reads_as_before(cell, tensors, params, spec_digest):
    """The same names, shapes, laws and order: ``make_params`` draws the
    same numbers."""
    spec = weights.param_spec(harness.cell(cell)["c"])
    assert len(spec) == tensors
    assert sum(weights._numel(s) for _, s, _ in spec) == params
    assert digest(spec) == spec_digest


@pytest.mark.parametrize("cell,tensors,params_digest", [
    ("flagship.train", 196, "9420c87e29c82acf"),
    ("vivit_small.train", 58, "cbe3f765305b2676")])
def test_make_params_draws_as_before(cell, tensors, params_digest, tiny_cell):
    P = weights.make_params(tiny_cell(cell)["c"], 2 ** 40 + 3, "cpu")
    h = hashlib.sha256()
    for k, t in P.items():
        h.update(k.encode())
        h.update(t.numpy().tobytes())
    assert len(P) == tensors
    assert h.hexdigest()[:16] == params_digest


def test_launch_lists_read_as_before(flagship, vivit_small):
    f, v = flagship, vivit_small
    lists = {
        "fee3f8b6cc74fce3": convnext_gru.k2_launches(f, 8, False),
        "efa8d52fc5ba90b9": convnext_gru.k2_launches(f, 8, True),
        "a1db2a00df4b6ada": convnext_gru.k2_wgrad_launches(f, 8),
        "a726b25c485914db": convnext_gru.k3_launches(f, 8, False),
        "1081a612a104750c": convnext_gru.k3_launches(f, 8, True),
        "78e60b814df8339f": vivit.k4_launches(v, 8, False),
        "23023dc21950d4c8": vivit.k4_launches(v, 8, True),
    }
    for want, launches in lists.items():
        assert digest([(x.ops, x.bytes, x.peak) for x in launches]) == want
    fwd = vivit.k4_launches(v, 8, False)
    assert sum(x.bound_s() for x in fwd) * 1e3 == pytest.approx(1.0818, abs=5e-5)
