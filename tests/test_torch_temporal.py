"""The port's bi-GRU head against the flax ``TemporalRNN`` (``_HoistedGRU``)
on bridged weights."""

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
