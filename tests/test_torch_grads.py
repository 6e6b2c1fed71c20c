"""The gradients of K2 and K3 on the CPU, where each ``autograd.Function``
runs its kernels' plain versions, against the JAX package's ``custom_vjp``s
with their Pallas kernels in interpret mode, on the same numpy inputs.

The CUDA kernels run only on a card: ``python3 chip_smoke.py`` holds K2's
weight gradient and K3's train variant against these plain versions there
at the flagship shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import bf16_ulp
from vision_collision_detection_tpu.ops.convnext_mlp_pallas import (
    _fwd as jax_k3_train_fwd,
)
from vision_collision_detection_tpu.ops.convnext_mlp_pallas import (
    convnext_mlp_block,
)
from vision_collision_detection_tpu.ops.dwconv_pallas import _run_wgrad
from vision_collision_detection_tpu.ops.dwconv_pallas import (
    dwconv7x7 as jax_dwconv7x7,
)
from vision_collision_detection_tpu_torch.ops import convnext_mlp as k3
from vision_collision_detection_tpu_torch.ops import dwconv as k2

K3_NAMES = ("ln_w", "ln_b", "w1", "b1", "w2", "b2", "gamma")


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _k2_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(0, 1 / 7, (7, 7, C)).astype(np.float32),
            rng.normal(0, 0.1, C).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 9, 10, 16), (1, 7, 7, 32)])
def test_k2_backward_matches_jax_custom_vjp(shape, dtype):
    x, w, b, g = _k2_inputs(shape, seed=sum(shape))
    jd = getattr(jnp, dtype)
    _, vjp = jax.vjp(jax_dwconv7x7, *(jnp.asarray(a, jd) for a in (x, w, b)))
    ref = [_f32(a) for a in vjp(jnp.asarray(g, jd))]
    td = getattr(torch, dtype)
    C = shape[-1]
    args = [torch.from_numpy(x).to(td), torch.from_numpy(w.reshape(49, C)).to(td),
            torch.from_numpy(b).to(td)]
    for a in args:
        a.requires_grad_(True)
    out = k2.dwconv7x7(*args)
    got = torch.autograd.grad(out, args, torch.from_numpy(g).to(td))
    assert [t.dtype for t in got] == [td] * 3
    for name, t, r in zip(("dx", "dw", "db"), got, ref):
        r = r.reshape(t.shape)
        if dtype == "float32":
            # tolerance: float32 sums over up to 49 taps or N·H·W terms in
            # another order
            np.testing.assert_allclose(_np(t), r, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            # tolerance: the same float32 sums, one bf16 rounding: 1 ulp
            assert np.all(np.abs(_np(t) - r) <= bf16_ulp(r)), name


@pytest.mark.parametrize("shape", [(3, 12, 10, 64), (4, 7, 7, 96)])
def test_k2_db_sums_bf16_g_as_read(shape):
    """K2's bias gradient on a bf16 g: Σg taken in float32 by the sum itself
    (``dtype=``, no float32 copy of g), rounded to bf16, against the JAX
    ``custom_vjp``'s db (Σ of g cast to float32, rounded to bf16)."""
    x, w, b, g = _k2_inputs(shape, seed=shape[1])
    # g of a few hundred terms per channel, each of order 1
    _, vjp = jax.vjp(jax_dwconv7x7,
                     *(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)))
    ref = _f32(vjp(jnp.asarray(g, jnp.bfloat16))[2])
    C = shape[-1]
    tb = torch.from_numpy(b).to(torch.bfloat16).requires_grad_(True)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    out = k2.dwconv7x7(torch.from_numpy(x).to(torch.bfloat16),
                       torch.from_numpy(w.reshape(49, C)).to(torch.bfloat16),
                       tb)
    (db,) = torch.autograd.grad(out, tb, tg)
    assert db.dtype == torch.bfloat16 and db.shape == (C,)
    assert torch.equal(db, tg.sum((0, 1, 2), dtype=torch.float32).to(
        torch.bfloat16))
    # tolerance: float32 sums of N·H·W bf16 terms in another order, one bf16
    # rounding: 1 ulp
    assert np.all(np.abs(_np(db) - ref) <= bf16_ulp(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_wgrad_plain_matches_pallas_wgrad(dtype):
    x, _, _, g = _k2_inputs((3, 8, 11, 16), seed=4)
    jd = getattr(jnp, dtype)
    xp = jnp.pad(jnp.asarray(x, jd), ((0, 0), (3, 3), (3, 3), (0, 0)))
    ref = np.asarray(_run_wgrad(xp, jnp.asarray(g, jd)))
    td = getattr(torch, dtype)
    got = k2.dwconv7x7_wgrad(torch.from_numpy(x).to(td),
                             torch.from_numpy(g).to(td))
    assert got.dtype == torch.float32 and got.shape == (49, 16)
    # tolerance: float32 sums of 264 products per tap in another order
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _k3_inputs(C, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 5, 6, C)).astype(np.float32)
    y = rng.normal(size=(2, 5, 6, C)).astype(np.float32)
    g = rng.normal(size=(2, 5, 6, C)).astype(np.float32)
    p = dict(
        ln_w=1 + 0.1 * rng.normal(size=C), ln_b=0.1 * rng.normal(size=C),
        w1=rng.normal(0, C ** -0.5, (C, 4 * C)),
        b1=0.1 * rng.normal(size=4 * C),
        w2=rng.normal(0, (4 * C) ** -0.5, (4 * C, C)),
        b2=0.1 * rng.normal(size=C), gamma=rng.uniform(0.5, 1.5, C))
    return x, y, g, {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("approximate", [True, False])
def test_k3_train_plain_matches_jax_fwd(approximate):
    x, y, _, p = _k3_inputs(32, seed=11)
    out, res = jax_k3_train_fwd(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16),
        *(jnp.asarray(p[k]) for k in K3_NAMES), approximate)
    ref = {"out": _f32(out), "t": _f32(res[1]), "h_pre": _f32(res[2]),
           "m": _f32(res[3])}
    got = k3.convnext_mlp_train(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(y).to(torch.bfloat16), approximate=approximate,
        **{k: torch.from_numpy(v) for k, v in p.items()})
    got = dict(zip(("out", "t", "h_pre", "m"), got))
    assert got["h_pre"].shape == (60, 128) and got["m"].shape == (60, 32)
    assert all(got[k].dtype == torch.bfloat16 for k in ("t", "h_pre", "m"))
    for name, r in ref.items():
        diff = np.abs(_np(got[name]).reshape(r.shape) - r)
        # t and h_pre: 1 bf16 ulp (float32 sums in another order, one
        # rounding); out and m: also the rare flip of h between the two
        # packages' GELU (the JAX one evaluates in bf16), 2 ulps of the
        # largest value, as in test_k3_plain_matches_pallas
        bound = bf16_ulp(r) + (0 if name in ("t", "h_pre")
                               else 2 * bf16_ulp(np.abs(r).max()))
        assert np.all(diff <= bound), (name, diff.max())


@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("C", [16, 32])
def test_k3_gradients_match_jax_vjp(C, approximate):
    x, y, g, p = _k3_inputs(C, seed=20 + C)
    jargs = [jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)] + [
        jnp.asarray(p[k]) for k in K3_NAMES]
    _, vjp = jax.vjp(lambda *a: convnext_mlp_block(*a, approximate), *jargs)
    ref = [_f32(a) for a in vjp(jnp.asarray(g, jnp.bfloat16))]
    targs = [torch.from_numpy(x).to(torch.bfloat16),
             torch.from_numpy(y).to(torch.bfloat16)] + [
        torch.from_numpy(p[k]) for k in K3_NAMES]
    for a in targs:
        a.requires_grad_(True)
    out = k3.convnext_mlp(*targs, approximate=approximate)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, targs, torch.from_numpy(g).to(torch.bfloat16))
    for name, t, a, r in zip(("x", "y") + K3_NAMES, got, targs, ref):
        assert t.dtype == a.dtype and t.shape == a.shape, name
        # tolerance, bf16-level: each gradient sums over 60 rows products of
        # bf16 values that flip by an ulp where h differs between the two
        # packages' GELU; 2 bf16 ulps of the largest |gradient|
        bound = 2 * bf16_ulp(np.abs(r).max())
        assert np.abs(_np(t) - r).max() <= bound, (name, np.abs(_np(t) - r).max())


def test_k3_without_gradient_keeps_the_eval_path():
    x, y, _, p = _k3_inputs(16, seed=5)
    args = [torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(y).to(torch.bfloat16)]
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    with torch.no_grad():
        out = k3.convnext_mlp(*args, approximate=True, **tp)
    assert out.grad_fn is None
    assert torch.equal(out, k3.convnext_mlp_plain(*args, approximate=True, **tp))


def test_kernel_path_keeps_the_graph(monkeypatch):
    """A tensor off the CPU takes each Function's kernel path. With the
    launches swapped for the plain versions (meta tensors carry shapes
    only), the outputs must still have a grad_fn and the backward must reach
    every input with its shape and dtype."""
    monkeypatch.setattr(k2, "_launch_fwd", k2.dwconv7x7_plain)
    monkeypatch.setattr(k2, "_launch_wgrad", k2.dwconv7x7_wgrad_plain)
    monkeypatch.setattr(k3, "_launch_train", k3.convnext_mlp_train_plain)
    seen = []
    monkeypatch.setattr(k3, "_mm_f32", lambda a, b: seen.append(a.device)
                        or a.float() @ b.float())
    C = 96
    meta = dict(device="meta")
    x = torch.empty(2, 8, 8, C, dtype=torch.bfloat16, **meta).requires_grad_()
    w = torch.empty(49, C, dtype=torch.bfloat16, **meta).requires_grad_()
    b = torch.empty(C, dtype=torch.bfloat16, **meta).requires_grad_()
    y = k2.dwconv7x7(x, w, b)
    assert y.grad_fn is not None and y.device.type == "meta"
    params = [torch.empty(*s, **meta).requires_grad_() for s in
              ((C,), (C,), (C, 4 * C), (4 * C,), (4 * C, C), (C,), (C,))]
    out = k3.convnext_mlp(x, y, *params, approximate=True)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out.float().sum(), [x, w, b] + params)
    assert [tuple(g.shape) for g in grads] == [tuple(a.shape) for a in
                                               [x, w, b] + params]
    assert [g.dtype for g in grads] == [a.dtype for a in [x, w, b] + params]
    assert len(seen) == 4 and all(d.type == "meta" for d in seen)
