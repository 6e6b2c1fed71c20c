"""The port's bi-GRU head against the flax ``TemporalRNN`` (``_HoistedGRU``)
on bridged weights."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import randomize_params
from vision_collision_detection_tpu.models.temporal import (
    TemporalRNN as FlaxTemporalRNN,
)
from vision_collision_detection_tpu_torch.models import temporal
from vision_collision_detection_tpu_torch.models.convert import (
    from_flax_params,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("bidirectional", [True, False])
def test_gru_head_matches_flax_fp32(bidirectional):
    B, T, D, H = 3, 7, 24, 16
    x = np.random.default_rng(0).normal(size=(B, T, D)).astype(np.float32)
    fm = FlaxTemporalRNN(dim=D, hidden=H, bidirectional=bidirectional)
    init = fm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = randomize_params(jax.device_get(init), np.random.default_rng(1))
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))

    tm = temporal.TemporalRNN(D, hidden=H, bidirectional=bidirectional)
    sd = from_flax_params({"temporal": params})
    tm.load_state_dict({k[len("temporal."):]: v for k, v in sd.items()},
                       strict=True)
    assert torch.all(tm.gru.bias_hh_l0[:2 * H] == 0)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (B, H)
    # tolerance: float32 recurrences, products summed in other orders
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_other_modes_wait_for_later_pr():
    for mode in ("attention", "conv", "pooling", "rnn", "lstm"):
        with pytest.raises(NotImplementedError, match="later PR"):
            temporal.build_temporal_head(mode, 8)
    with pytest.raises(ValueError):
        temporal.build_temporal_head("nope", 8)
    assert temporal.temporal_out_dim("gru", 768, 256) == 256
    assert temporal.temporal_out_dim("pooling", 768, 256) == 768


def test_bridge_rejects_incomplete_gru_cell():
    cell = {g: {"kernel": np.zeros((4, 4), np.float32)}
            for g in ("ir", "iz", "in", "hr", "hz")}
    with pytest.raises(KeyError):
        from_flax_params({"temporal": {"fw_cell": cell}})


def _flags():
    c = torch.backends.cudnn
    try:
        legacy = c.allow_tf32
    except RuntimeError:  # conv and RNN set apart through per-op flags
        legacy = "mixed"
    return legacy, c.conv.fp32_precision, c.rnn.fp32_precision


def _pinned_forward_backward():
    """One forward and backward of the head; the flags a forward pre-hook
    on its ``nn.GRU`` sees, the flags inside the backward of the
    recurrence's node, and the caller's flags after each."""
    tm = temporal.TemporalRNN(6, hidden=4)
    seen = {}
    outs = []
    tm.gru.register_forward_pre_hook(
        lambda m, args: seen.__setitem__("forward", _flags()))
    tm.gru.register_forward_hook(lambda m, args, out: outs.append(out[0]))
    x = torch.randn(2, 5, 6, requires_grad=True)
    y = tm(x)
    seen["after_forward"] = _flags()
    node = outs[0].grad_fn
    # registered after the pin's own hooks, so they run inside its span
    node.register_prehook(
        lambda g: seen.__setitem__("backward", _flags()))
    node.register_hook(
        lambda gi, go: seen.__setitem__("after_node", _flags()))
    y.sum().backward()
    seen["after_backward"] = _flags()
    return seen


@pytest.mark.parametrize("caller_tf32", [True, False])
def test_gru_runs_with_tf32_off_and_restores_the_flag(caller_tf32):
    c = torch.backends.cudnn
    c.allow_tf32 = caller_tf32
    try:
        before = _flags()
        seen = _pinned_forward_backward()
    finally:
        c.allow_tf32 = True
    assert before[0] is caller_tf32
    assert seen["forward"][0] is False and seen["backward"][0] is False
    for when in ("after_forward", "after_node", "after_backward"):
        assert seen[when] == before, when


def test_gru_pin_restores_per_operator_flags():
    """A caller who set cuDNN's RNN precision apart through the per-operator
    flag (the legacy getter then raises) gets that flag back as it was.
    (In a process of its own: the flags are global.)"""
    code = "\n".join([
        "import sys, torch",
        f"sys.path.insert(0, {str(ROOT)!r})",
        "from vision_collision_detection_tpu_torch.models import temporal",
        _source_of(_flags),
        _source_of(_pinned_forward_backward),
        "torch.backends.cudnn.rnn.fp32_precision = 'ieee'",
        "before = _flags()",
        "seen = _pinned_forward_backward()",
        "assert before == ('mixed', 'tf32', 'ieee'), before",
        "assert seen['forward'][0] is False, seen",
        "assert seen['backward'][0] is False, seen",
        "assert seen['after_forward'] == before, seen",
        "assert seen['after_backward'] == before, seen",
        "print('ok')"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _source_of(fn):
    import inspect

    return inspect.getsource(fn)
