"""K4 on the CPU: ``flash_mha``'s plain version, its written-out backward and
``FlashSelfAttention`` against the JAX package, on the same numpy inputs.

The references are what the JAX package's own tests reach on the CPU: the
JAX library's pure-``jnp`` ``mha_reference_no_custom_vjp`` (the function its
Pallas TPU kernels are tested against; a padded length is masked by segment
ids, as ``flash_mha`` of the JAX package pads 576 to 640), ``jax.grad`` of
it, and the einsum branch of the JAX ``FlashSelfAttention``.

The CUDA kernels run only on a card: ``python3 chip_smoke.py`` holds them
against these plain versions there. The float32 kernels' split products
(three bf16 products for each float32 one) are emulated here, against
float64, to show before any card that they meet the float32 rule that
``chip_smoke.py`` holds them to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jax_fa

from torch_port_helpers import bf16_ulp, randomize_params
from vision_collision_detection_tpu.ops.flash_attention import (
    FlashSelfAttention as JaxFlashSelfAttention,
)
from vision_collision_detection_tpu_torch.models.convert import (
    from_flax_params,
)
from vision_collision_detection_tpu_torch.ops import flash_attention as fa

# (B, S, H, D): a length under the TPU kernel's 128, one that it pads
# (130 → 256), head_dim 16 (vivit_tiny) and 64 (vivit_small, vivit_base)
SHAPES = [(2, 4, 4, 16), (1, 130, 2, 64), (2, 37, 3, 16)]


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _qkv(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _round_bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


def _jax_reference(q, k, v, sm_scale):
    """The library's reference on [B, S, H, D] float32 arrays, the sequence
    zero-padded to a multiple of 128 and masked by segment ids as the JAX
    package's ``flash_mha`` does it; → [B, S, H, D]."""
    B, S = q.shape[:2]
    padded = -(-S // 128) * 128
    pad = [(0, 0), (0, padded - S), (0, 0), (0, 0)]
    ids = jnp.broadcast_to((jnp.arange(padded) < S).astype(jnp.int32)[None],
                           (B, padded))
    qt, kt, vt = (jnp.swapaxes(jnp.pad(t, pad), 1, 2) for t in (q, k, v))
    out = jax_fa.mha_reference_no_custom_vjp(
        qt, kt, vt, None, jax_fa.SegmentIds(q=ids, kv=ids), sm_scale=sm_scale)
    return jnp.swapaxes(out, 1, 2)[:, :S]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_the_library_reference(shape, dtype):
    q, k, v = _qkv(shape, seed=sum(shape))
    scale = shape[-1] ** -0.5
    td = getattr(torch, dtype)
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        q, k, v = (_round_bf16(a) for a in (q, k, v))
    ref = np.asarray(_jax_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                    scale))
    got = fa.flash_mha(*(torch.from_numpy(a).to(td) for a in (q, k, v)), scale)
    assert got.dtype == td and got.shape == shape and got.is_contiguous()
    if dtype == "float32":
        # tolerance: float32 sums of up to 130 products in another order
        np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-6)
    else:
        # tolerance: p rounded to bf16 (2^-9 relative on each weight of a
        # convex sum) and the output rounded once: 2 bf16 ulps of the
        # largest |o|
        assert np.abs(_np(got) - ref).max() <= 2 * bf16_ulp(np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_jax_grad_of_the_reference(shape, dtype):
    q, k, v, g = _qkv(shape, seed=1 + sum(shape), n=4)
    scale = shape[-1] ** -0.5
    td = getattr(torch, dtype)
    if dtype == "bfloat16":
        q, k, v, g = (_round_bf16(a) for a in (q, k, v, g))
    ref = jax.grad(lambda *a: jnp.sum(_jax_reference(*a, scale)
                                      * jnp.asarray(g)), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).to(td).requires_grad_(True)
              for a in (q, k, v)]
    launches = (fa.flash_mha.launches, fa.flash_mha_bwd_dkv.launches,
                fa.flash_mha_bwd_dq.launches)
    out = fa.flash_mha(*leaves, scale)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(td))
    # a CPU tensor takes the plain versions: nothing launched
    assert launches == (fa.flash_mha.launches, fa.flash_mha_bwd_dkv.launches,
                        fa.flash_mha_bwd_dq.launches)
    for name, t, r in zip(("dq", "dk", "dv"), got, ref):
        r = np.asarray(r)
        assert t.dtype == td and t.shape == shape, name
        if dtype == "float32":
            # tolerance: float32 sums in another order, and exp(s − lse)
            # against exp(s − m) / l
            np.testing.assert_allclose(_np(t), r, rtol=2e-5, atol=2e-6,
                                       err_msg=name)
        else:
            # tolerance: o, p and ds rounded to bf16 before their products
            # (each 2^-9 relative), the result rounded once: 2 bf16 ulps of
            # the largest |gradient|
            bound = 2 * bf16_ulp(np.abs(r).max())
            assert np.abs(_np(t) - r).max() <= bound, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_row_term_matches_row_dot_and_the_library(shape, dtype):
    """``flash_mha_bwd_di`` on the CPU is ``_row_dot``, and both are the
    library's ``jnp.sum(o.astype(f32) * do.astype(f32), -1)`` (its
    ``_flash_attention_bwd``), here as [B, H, S]. Both sum D float32
    products, in another order: 2^-20 of the largest Σ|o·do| of a row."""
    o, do = _qkv(shape, seed=sum(shape) + 1, n=2)
    dt = getattr(torch, dtype)
    to, tdo = (torch.from_numpy(a).to(dt) for a in (o, do))
    di = fa.flash_mha_bwd_di(to, tdo)
    assert di.dtype == torch.float32
    assert tuple(di.shape) == (shape[0], shape[2], shape[1])
    assert torch.equal(di, fa._row_dot(to, tdo))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jo, jdo = (jnp.asarray(a).astype(jdt) for a in (o, do))
    want = jnp.sum(jo.astype(jnp.float32) * jdo.astype(jnp.float32), axis=-1)
    want = np.asarray(want).transpose(0, 2, 1)
    tol = float((to.float() * tdo.float()).abs().sum(-1).max()) * 2 ** -20
    assert np.abs(_np(di) - want).max() <= tol


def test_row_term_reads_strided_views():
    """o and do as transposed views (the gradient arrives so in training)
    give what their contiguous copies give."""
    o, do = (torch.from_numpy(a).permute(0, 2, 1, 3)
             for a in _qkv((2, 3, 9, 16), seed=5, n=2))
    assert not do.is_contiguous()
    assert torch.equal(fa.flash_mha_bwd_di(o, do),
                       fa.flash_mha_bwd_di(o.contiguous(), do.contiguous()))


@pytest.mark.parametrize("shape", SHAPES)
def test_prescaled_exponent_form_is_the_plain_backward(shape):
    """The Hopper backward kernels compute p = 2^(s·scale·log2e − lse·log2e)
    and ds = p·(dp·scale − di·scale), with lse·log2e and di·scale prepared
    once per row, where the plain version writes exp(s·scale − lse) and
    p·(dp − di)·scale. In float32 the two forms differ by roundings of
    single operations on exponents of order 10: each p within 2^-18
    relative, ds within 2^-18 of the largest |ds|."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(shape, seed=9, n=4))
    scale = shape[-1] ** -0.5
    o, lse = fa._flash_fwd_plain(q, k, v, scale)
    di = fa._row_dot(o, do)
    p_ref, ds_ref = fa._bwd_p_ds(q, k, v, do, lse, di, scale)
    log2e = 1.4426950408889634
    qf, kf, vf, dof = (fa._heads_first(t) for t in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2))
    p = torch.exp2(s * (scale * log2e) - (lse * log2e)[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp * scale - (di * scale)[..., None])
    assert ((p - p_ref).abs() <= p_ref * 2 ** -18 + 1e-30).all()
    assert float((ds - ds_ref).abs().max()) <= float(
        ds_ref.abs().max()) * 2 ** -18


def _bf16_values(x):
    """float32 values rounded to bf16 (to nearest even), as float64."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float64).numpy()


def _tf32_values(x):
    """float32 values rounded to TF32's 10 mantissa bits (to nearest
    even), as float64."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _split_parts(x, parts):
    """float32 x as ``parts`` bf16 values, each the rounding of what the
    ones before leave (exact in float32), as float64."""
    rest, out = np.asarray(x, np.float32), []
    for _ in range(parts):
        out.append(_bf16_values(rest))
        rest = (rest - out[-1]).astype(np.float32)
    return out


def _emulated_product(a, b, mode, a_parts=2, b_parts=2):
    """a @ b as the tensor cores would take float32 operands, every product
    of two rounded values exact and every sum in float64 (the kernels'
    float32 accumulation adds 2^-24, far under what is held here):
    ``"split"`` the float32 kernels' bf16 products of x = hi + lo
    (hi = bf16(x), lo = bf16(x − hi)) or, for v and do, x = hi + lo + lo2:
    with both operands in two parts lo·hi + hi·lo + hi·hi, with one in
    three every term down to 2^-18 (lo·lo and hi·lo2 too); ``"bf16"`` and
    ``"tf32"`` one pass on operands rounded once; ``"exact"`` float64."""
    if mode == "exact":
        return np.asarray(a, np.float64) @ np.asarray(b, np.float64)
    if mode == "split":
        top = 2 if 3 in (a_parts, b_parts) else 1
        pa, pb = _split_parts(a, a_parts), _split_parts(b, b_parts)
        return sum(x @ y for i, x in enumerate(pa) for j, y in enumerate(pb)
                   if i + j <= top)
    rounded = _bf16_values if mode == "bf16" else _tf32_values
    return rounded(a) @ rounded(b)


def _emulated_attention(q, k, v, do, scale, mode, parts=3):
    """(o, dq, dk, dv, lse, di) of one (batch, head) [S, D] with the
    kernels' order of work: the forward's logits, o = p·v / l and the
    log-sum-exp; the backward's p recomputed from it, dp = do·vᵀ,
    di = Σ o·do and ds = p·(dp − di)·scale; every product by
    ``_emulated_product`` (v and do in ``parts``), p, ds and o rounded to
    float32 where the kernels hold them in float32."""
    f32 = ((lambda x: x) if mode == "exact"
           else (lambda x: np.asarray(x, np.float32).astype(np.float64)))
    s = _emulated_product(q, k.T, mode)
    m = s.max(-1, keepdims=True)
    p = np.exp((s - m) * scale)
    l = p.sum(-1, keepdims=True)
    o = f32(_emulated_product(f32(p), v, mode, b_parts=parts) / l)
    lse = m * scale + np.log(l)
    di = (o * np.asarray(do, np.float64)).sum(-1, keepdims=True)
    p = f32(np.exp(s * scale - lse))
    dp = _emulated_product(do, v.T, mode, a_parts=parts, b_parts=parts)
    ds = f32(p * (dp - di) * scale)
    return (o, _emulated_product(ds, k, mode),
            _emulated_product(ds.T, q, mode), _emulated_product(p.T, do, mode),
            lse, di)


def _held_to_split_pass(q, k, v, do):
    """The emulation's operand parts are those of the float32 kernels'
    split pass: ``flash_mha_split_plain`` of the same [S, D] operands."""
    split = fa.flash_mha_split_plain(
        *(torch.from_numpy(a)[None, :, None] for a in (q, k, v, do)))
    want = [x for a, n in zip((q, k, v, do), (2, 2, 3, 3))
            for x in _split_parts(a, n)]
    assert len(want) == split.shape[0]
    for i, w in enumerate(want):
        assert np.array_equal(split[i, 0, :, 0].double().numpy(), w)


@pytest.mark.parametrize("S,D", [(576, 64), (256, 16)])
@pytest.mark.parametrize("mode,meets", [("split", True), ("bf16", False),
                                        ("tf32", False)])
def test_split_products_meet_the_float32_rule(mode, meets, S, D):
    """The float32 kernels' accuracy argument, before any card: at one
    (batch, head) of the scaled configuration's shape (S = 576, D = 64)
    and of vivit_tiny's (S = 256, D = 16) on seeded inputs, split by the
    split pass's plain version, the split products hold o, dq, dk and dv
    within ``chip_smoke.py``'s float32 rule (2^-14 of the largest value, on
    the largest and the mean error) of float64, where one bf16 pass (8
    mantissa bits) or one TF32 pass (11) lands outside it on every one.
    (At D = 64 the split read about 1.1e-5 of the largest value, 5× inside
    the rule.)"""
    q, k, v, do = _qkv((S, D), seed=20, n=4)
    _held_to_split_pass(q, k, v, do)
    scale = D ** -0.5
    want = _emulated_attention(*(a.astype(np.float64) for a in (q, k, v, do)),
                               scale, "exact")
    got = _emulated_attention(q, k, v, do, scale, mode)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        rule = 2 ** -14 * np.abs(w).max()
        err = np.abs(g - w)
        if meets:
            assert err.max() <= rule and err.mean() <= rule, name
        else:
            assert err.max() > rule, name


@pytest.mark.parametrize("D", [64, 16])
@pytest.mark.parametrize("parts,meets", [(3, True), (2, False)])
def test_one_key_needs_v_and_do_in_three_parts(parts, meets, D):
    """With one key the softmax has one weight: dq and dk are 0 in exact
    arithmetic, and ``chip_smoke.py`` holds the kernels there to the plain
    backward given the kernels' own lse and di within 2^-20 of
    scale·Σ|do·v|. di = Σ o·do comes from the forward's o: with v in two
    parts o carries v's split residual (2^-18 of |v|) into di, and dp = do·vᵀ
    carries do's, and the plain version (exact v and do) sees both. With v
    and do in three parts and every term of their products down to 2^-18
    the kernels land far inside (under a tenth); in two, outside, as an
    H100 read it (dq 1.4e-5 against 6.2e-6 at [3, 1, 2, 64]). At head_dim
    64 and 16."""
    scale = D ** -0.5
    rows = [_qkv((1, D), seed=100 + i, n=4) for i in range(32)]
    _held_to_split_pass(*rows[0])
    floor = scale * 2 ** -20 * max(
        float(np.abs(do * v).sum()) for _, _, v, do in rows)
    worst = 0.0
    for q, k, v, do in rows:
        _, dq, dk, _, lse, di = _emulated_attention(q, k, v, do, scale,
                                                    "split", parts=parts)
        qf, kf, vf, dof = (a.astype(np.float64) for a in (q, k, v, do))
        p = np.exp(qf @ kf.T * scale - lse)
        ds = p * (dof @ vf.T - di) * scale
        worst = max(worst, np.abs(dq - ds @ kf).max(),
                    np.abs(dk - ds.T @ qf).max())
    assert (worst <= floor / 10) if meets else (worst > floor)


def test_written_out_backward_is_autograd_of_the_plain_forward():
    shape = (2, 37, 3, 16)
    q, k, v, g = (torch.from_numpy(a) for a in _qkv(shape, seed=3, n=4))
    scale = 0.25
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_mha_plain(*leaves, scale)
    want = torch.autograd.grad(o, leaves, g)
    o2, lse = fa.flash_mha_fwd(q, k, v, scale)
    assert torch.equal(o2, o.detach())
    assert lse.shape == (2, 3, 37) and lse.dtype == torch.float32
    di = fa._row_dot(o2, g)
    dk, dv = fa.flash_mha_bwd_dkv(q, k, v, g, lse, di, scale)
    got = (fa.flash_mha_bwd_dq(q, k, v, g, lse, di, scale), dk, dv)
    for name, t, w in zip(("dq", "dk", "dv"), got, want):
        # tolerance: the same float32 formulas in another order
        np.testing.assert_allclose(_np(t), _np(w), rtol=2e-5, atol=2e-6,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim,heads,seq", [(64, 4, 4), (128, 2, 21)])
def test_module_matches_jax_flash_self_attention(dim, heads, seq, dtype):
    jmod = JaxFlashSelfAttention(num_heads=heads, dtype=getattr(jnp, dtype))
    x = np.random.default_rng(dim + seq).normal(size=(2, seq, dim)).astype(
        np.float32)
    params = randomize_params(jax.device_get(jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]),
        np.random.default_rng(4))
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)),
                     np.float32)
    tmod = fa.FlashSelfAttention(dim, heads, getattr(torch, dtype))
    tmod.load_state_dict(from_flax_params(params), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, seq, dim)
    if dtype == "float32":
        # tolerance: float32 products in another order through four
        # projections and the attention
        np.testing.assert_allclose(_np(got), ref, rtol=2e-5, atol=2e-5)
    else:
        # tolerance: bf16 roundings of q, k, v, p and o flip by an ulp
        # between the two frameworks' float32 sums, and the out projection
        # sums `dim` of them: 4 bf16 ulps of the largest output
        assert np.abs(_np(got) - ref).max() <= 4 * bf16_ulp(np.abs(ref).max())


def test_module_parameters_are_those_of_flax_attention():
    import flax.linen as nn

    ref = nn.MultiHeadDotProductAttention(num_heads=4, dtype=jnp.float32)
    x = jnp.zeros((1, 5, 32))
    tree = jax.device_get(ref.init(jax.random.PRNGKey(0), x, x)["params"])
    sd = from_flax_params(randomize_params(tree, np.random.default_rng(0)))
    tmod = fa.FlashSelfAttention(32, 4, torch.float32)
    assert sd.keys() == tmod.state_dict().keys()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in tmod.state_dict().items()}


def test_kernel_path_keeps_the_graph(monkeypatch):
    """A tensor off the CPU takes the Function's kernel path. With the four
    launches swapped for their plain twins (meta tensors carry shapes only),
    the output must have a grad_fn and the backward must reach q, k and v
    through the di, the dK/dV and the dQ launch, once each, with the shapes
    and dtypes the C entries take."""
    calls, seen_args = [], {}

    def twin(name, fn):
        def run(*args, **kwargs):
            calls.append(name)
            seen_args[name] = [(tuple(a.shape), a.dtype) for a in args
                               if isinstance(a, torch.Tensor)]
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(fa, "_launch_fwd", twin("fwd", fa._flash_fwd_plain))
    monkeypatch.setattr(fa, "_launch_bwd_di", twin("di", fa._row_dot))
    monkeypatch.setattr(fa, "_launch_bwd_dkv",
                        twin("dkv", fa.flash_mha_bwd_dkv_plain))
    monkeypatch.setattr(fa, "_launch_bwd_dq",
                        twin("dq", fa.flash_mha_bwd_dq_plain))
    x = torch.empty(2, 576, 384, dtype=torch.bfloat16, device="meta")
    mod = fa.FlashSelfAttention(384, 6).to("meta")
    out = mod(x)
    assert out.grad_fn is not None and out.device.type == "meta"
    params = list(mod.parameters())
    grads = torch.autograd.grad(out.float().sum(), params)
    assert [tuple(g.shape) for g in grads] == [tuple(p.shape) for p in params]
    assert calls == ["fwd", "di", "dkv", "dq"]
    operand = ((2, 576, 6, 64), torch.bfloat16)   # [B, S, H, D]
    stat = ((2, 6, 576), torch.float32)           # [B, H, S]
    assert seen_args["di"] == [operand] * 2       # o, do
    assert seen_args["dkv"] == seen_args["dq"] == [operand] * 4 + [stat] * 2
    # without a gradient the call is the op vcd::flash_mha (swapped here for
    # its implementation: the op gives a meta tensor its fake), which runs
    # the forward alone and saves no log-sum-exp
    from vision_collision_detection_tpu_torch.ops import library

    seen = []
    monkeypatch.setattr(fa, "_launch_fwd", lambda q, k, v, s, need_lse: (
        seen.append(need_lse) or fa._flash_fwd_plain(q, k, v, s, need_lse)))
    monkeypatch.setattr(library, "flash_mha", lambda q, k, v, s: (
        seen.append("op") or fa._forward(q, k, v, s)))
    with torch.no_grad():
        assert mod(x).grad_fn is None
    assert seen == ["op", False]


def test_dispatch_has_no_hidden_fallback():
    q = torch.randn(2, 8, 2, 16)
    assert torch.equal(fa.flash_mha(q, q, q, 0.25),
                       fa.flash_mha_plain(q, q, q, 0.25))
    # off the CPU the kernels run or the call raises, at any length: what
    # they do not take is refused, never handed to the plain version (the
    # forward through its op's implementation: the op gives a meta tensor
    # its fake)
    for bad in (torch.empty(2, 8, 2, 32, dtype=torch.bfloat16, device="meta"),
                torch.empty(2, 8, 2, 64, dtype=torch.float16, device="meta")):
        with pytest.raises(ValueError, match="flash_mha kernels take"):
            fa._forward(bad, bad, bad, 1.0)
        with pytest.raises(ValueError, match="flash_mha kernels take"):
            fa.flash_mha_bwd_di(bad, bad)
    meta = torch.empty(2, 8, 2, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa._forward(meta, meta, meta, 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_mha_bwd_di(meta, meta)
    with pytest.raises(ValueError, match="do must be"):
        fa.flash_mha_bwd_di(meta, meta[:, :4])
    with pytest.raises(ValueError, match="one shape"):
        fa.flash_mha(q, q[:, :4], q, 1.0)
    with pytest.raises(ValueError, match="divisible"):
        fa.FlashSelfAttention(30, 4)
