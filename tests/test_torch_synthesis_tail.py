"""The port's chain-tail plain versions (certifyingfacerecognition_torch.
ops.synthesis_tail_bc, taken by the wrappers for CPU tensors) against the
JAX package's Pallas functions run in interpret mode on the CPU.

Tolerances: f32 rtol=atol=5e-4 (the JAX package's own bound for these
kernels). bf16 rtol=atol=3e-2; measured worst case at these shapes: 0.0
for the activations and images (the plain versions round at the same
points as the Pallas kernels), and the f32 sums agree to f32 summation
order (<1e-6 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.ops import synthesis_tail_bc as jbc
from certifyingfacerecognition_torch.ops import synthesis_tail_bc as tbc

TOL = {"f32": dict(rtol=5e-4, atol=5e-4), "bf16": dict(rtol=3e-2, atol=3e-2)}
SUMS_RTOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _mk(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _aff(rng, c, b):
    return np.stack([_mk(rng, (c, b), 0.3) + 1.0, _mk(rng, (c, b))])


def _pair(a, dt):
    """The same array for both packages, in the activation dtype."""
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    return jnp.asarray(a, jdt), torch.tensor(a).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _close_sums(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=SUMS_RTOL,
                               atol=SUMS_RTOL * np.abs(want).max())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("apply_aff", [False, True])
def test_up_fused_matches_pallas(dt, apply_aff):
    rng = _rng(1)
    h, b, ci, co = 8, 8, 16, 8
    xj, xt = _pair(_mk(rng, (h, h, ci, b)), dt)
    k4, nb, aff = (_mk(rng, (4, 4, ci, co), 0.2), _mk(rng, (2 * h, 2 * h, co)),
                   _aff(rng, ci, b))
    tj, sj = jbc._up_fused(xj, jnp.asarray(k4), jnp.asarray(nb),
                           jnp.asarray(aff), 1e-8, apply_aff=apply_aff)
    tt, st = tbc.up_fused(xt, torch.tensor(k4), torch.tensor(nb),
                          torch.tensor(aff), apply_aff=apply_aff)
    assert tt.shape == (2 * h, 2 * h, co, b) and tt.dtype == xt.dtype
    _close(tt, tj, TOL[dt])
    _close_sums(st, sj)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("apply_aff", [False, True])
def test_conv_kernels_match_pallas(dt, apply_aff):
    """conv_fused, final_stats and final_apply on one input."""
    rng = _rng(2)
    h, b, ci, co = 8, 8, 16, 16
    xj, xt = _pair(_mk(rng, (h, h, ci, b)), dt)
    k, nb, aff = (_mk(rng, (3, 3, ci, co), 0.2), _mk(rng, (h, h, co)),
                  _aff(rng, ci, b))
    coefs, w_rgb, b_rgb = (_aff(rng, co, b), _mk(rng, (co, 3), 0.3),
                           _mk(rng, (3,)))
    J = [jnp.asarray(a) for a in (k, nb, aff, coefs, w_rgb, b_rgb)]
    T = [torch.tensor(a) for a in (k, nb, aff, coefs, w_rgb, b_rgb)]

    tj, sj = jbc._conv_fused(xj, *J[:3], 1e-8, apply_aff=apply_aff)
    tt, st = tbc.conv_fused(xt, *T[:3], apply_aff=apply_aff)
    _close(tt, tj, TOL[dt])
    _close_sums(st, sj)

    _close_sums(tbc.final_stats(xt, *T[:3], apply_aff=apply_aff),
                jbc._final_stats(xj, *J[:3], 1e-8, apply_aff=apply_aff))

    img = tbc.final_apply(xt, *T, apply_aff=apply_aff)
    assert img.shape == (3, h, h, b) and img.dtype == xt.dtype
    _close(img, jbc._final_apply(xj, *J, apply_aff=apply_aff), TOL[dt])


def test_coefs_from_sums_matches_jax():
    rng = _rng(3)
    sums = np.stack([_mk(rng, (8, 4), 10.0), np.abs(_mk(rng, (8, 4), 50.0))])
    s0p1, s1 = _mk(rng, (8, 4)) + 1.0, _mk(rng, (8, 4))
    want = jbc._coefs_from_sums(jnp.asarray(sums), 64, jnp.asarray(s0p1),
                                jnp.asarray(s1), 1e-8)
    got = tbc.coefs_from_sums(torch.tensor(sums), 64, torch.tensor(s0p1),
                              torch.tensor(s1), 1e-8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _ladder(seed, b, h, ladder):
    rng = _rng(seed)
    blocks = []
    for cin, cout in ladder:
        blocks.append({
            "k4": _mk(rng, (4, 4, cin, cout), 0.2),
            "up_nb": _mk(rng, (2 * h, 2 * h, cout)),
            "up_s0p1": _mk(rng, (b, cout)) + 1.0,
            "up_s1": _mk(rng, (b, cout)),
            "k": _mk(rng, (3, 3, cout, cout), 0.2),
            "conv_nb": _mk(rng, (2 * h, 2 * h, cout)),
            "conv_s0p1": _mk(rng, (b, cout)) + 1.0,
            "conv_s1": _mk(rng, (b, cout)),
        })
        h *= 2
    blocks[-1]["w_rgb"] = _mk(rng, (ladder[-1][1], 3), 0.3)
    blocks[-1]["b_rgb"] = _mk(rng, (3,))
    return blocks


def test_tail_chain_three_blocks_matches_pallas_chain():
    """tail_chain_bc on the JAX tests' three-block ladder (a true middle
    block receives a deferred affine and defers its own), f32."""
    b, h = 8, 4
    blocks = _ladder(100, b, h, [(32, 16), (16, 8), (8, 8)])
    x = _mk(_rng(101), (h, h, 32, b))
    want = jbc.tail_chain_bc(jnp.asarray(x), tuple(
        {k: jnp.asarray(v) for k, v in blk.items()} for blk in blocks))
    got = tbc.tail_chain_bc(torch.tensor(x), [
        {k: torch.tensor(v) for k, v in blk.items()} for blk in blocks])
    assert got.shape == (3, 32, 32, b)
    _close(got, want, TOL["f32"])


def test_tail_chain_bf16_matches_pallas_chain():
    """Two-block chain in bf16 (the 512^2/1024^2 structure at test scale)."""
    b, h = 8, 4
    blocks = _ladder(200, b, h, [(16, 8), (8, 8)])
    x = _mk(_rng(201), (h, h, 16, b))
    want = jbc.tail_chain_bc(jnp.asarray(x, jnp.bfloat16), tuple(
        {k: jnp.asarray(v) for k, v in blk.items()} for blk in blocks))
    got = tbc.tail_chain_bc(torch.tensor(x).bfloat16(), [
        {k: torch.tensor(v) for k, v in blk.items()} for blk in blocks])
    _close(got, want, TOL["bf16"])


def test_wrappers_take_plain_version_only_on_cpu():
    """A tensor on another device than the CPU never reaches the plain
    version: the wrapper checks it for the kernel and raises on what the
    kernel does not take."""
    x = torch.zeros((4, 4, 8, 8), device="meta")
    aff = torch.zeros((2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbc.conv_fused(x, torch.zeros((3, 3, 8, 8), device="meta"),
                       torch.zeros((4, 4, 8), device="meta"), aff)
    tbc.reset_launches()
    cpu = torch.zeros((4, 4, 8, 8))
    tbc.conv_fused(cpu, torch.zeros((3, 3, 8, 8)), torch.zeros((4, 4, 8)),
                   torch.zeros((2, 8, 8)))
    assert tbc.LAUNCHES == {k: 0 for k in tbc.LAUNCHES}


# ---------------------------------------------------------------------------
# The standalone half-layers and the gradients. Tolerances: f32 outputs
# rtol=atol=2e-4 (the JAX package's own tests of these ops); gradients
# rtol=atol=5e-4 against jax.grad of the JAX references (their bound);
# the chain gradient to 1e-4 of its largest value.
# ---------------------------------------------------------------------------

def _half_layer(rng, h, w, b, ci, co, up):
    """x, k, nb, s0p1, s1 of one standalone half-layer, as numpy."""
    oh, ow = (2 * h, 2 * w) if up else (h, w)
    return (_mk(rng, (h, w, ci, b)), _mk(rng, (4, 4, ci, co) if up
                                         else (3, 3, ci, co), 0.2),
            _mk(rng, (oh, ow, co)), _mk(rng, (b, co)) + 1.0,
            _mk(rng, (b, co)))


@pytest.mark.parametrize("h,w,b,ci,co", [(16, 16, 8, 16, 16),
                                         (8, 32, 16, 8, 8),
                                         (32, 8, 8, 8, 16),
                                         (16, 16, 8, 32, 32)])
def test_conv_epilogue_matches_pallas(h, w, b, ci, co):
    a = _half_layer(_rng(10), h, w, b, ci, co, up=False)
    want = jbc.conv_epilogue_bc(*map(jnp.asarray, a))
    got = tbc.conv_epilogue_bc(*map(torch.tensor, a))
    assert got.shape == (h, w, co, b)
    _close(got, want, dict(rtol=2e-4, atol=2e-4))


def test_conv_epilogue_rgb_matches_pallas():
    rng = _rng(11)
    a = _half_layer(rng, 16, 16, 8, 16, 16, up=False) + (
        _mk(rng, (16, 3), 0.3), _mk(rng, (3,)))
    want = jbc.conv_epilogue_rgb_bc(*map(jnp.asarray, a))
    got = tbc.conv_epilogue_rgb_bc(*map(torch.tensor, a))
    assert got.shape == (3, 16, 16, 8)
    _close(got, want, dict(rtol=2e-4, atol=2e-4))


@pytest.mark.parametrize("h,w,b,ci,co", [(8, 8, 8, 16, 8),
                                         (16, 8, 8, 8, 16),
                                         (8, 16, 16, 8, 8),
                                         (8, 8, 8, 64, 32)])
def test_upconv_blur_epilogue_matches_pallas(h, w, b, ci, co):
    a = _half_layer(_rng(12), h, w, b, ci, co, up=True)
    want = jbc.upconv_blur_epilogue_bc(*map(jnp.asarray, a))
    got = tbc.upconv_blur_epilogue_bc(*map(torch.tensor, a))
    assert got.shape == (2 * h, 2 * w, co, b)
    _close(got, want, dict(rtol=2e-4, atol=2e-4))


@pytest.mark.parametrize("op", ["conv", "conv_rgb", "up"])
def test_standalone_gradients_match_jax_refs(op):
    """Gradients with respect to x, nb and the styles (and the ToRGB
    weights) against jax.grad of the JAX reference. The JAX package's
    frozen convolutions give its conv weights zero gradient; the port's
    weights take none, so they are left out."""
    rng = _rng(13)
    a = list(_half_layer(rng, 8, 8, 8, 16, 16, up=op == "up"))
    if op == "conv_rgb":
        a += [_mk(rng, (16, 3), 0.3), _mk(rng, (3,))]
    jref = {"conv": jbc._conv_ref, "conv_rgb": jbc._conv_rgb_ref,
            "up": jbc._upconv_ref}[op]
    tfn = {"conv": tbc.conv_epilogue_bc, "conv_rgb": tbc.conv_epilogue_rgb_bc,
           "up": tbc.upconv_blur_epilogue_bc}[op]
    wrt = [i for i in range(len(a)) if i != 1]
    ja = [jnp.asarray(v) for v in a]
    cot = _mk(rng, np.asarray(jref(*ja, 1e-8)).shape)

    def jloss(*free):
        args = list(ja)
        for i, v in zip(wrt, free):
            args[i] = v
        return jnp.sum(jref(*args, 1e-8) * cot)

    want = jax.grad(jloss, argnums=tuple(range(len(wrt))))(
        *[ja[i] for i in wrt])
    ta = [torch.tensor(v, requires_grad=i in wrt) for i, v in enumerate(a)]
    got = torch.autograd.grad((tfn(*ta) * torch.tensor(cot)).sum(),
                              [ta[i] for i in wrt])
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=5e-4,
                                   atol=5e-4)


def test_tail_chain_gradient_matches_jax_chain_ref():
    """tail_chain_bc's backward (the vjp of the plain chain with one
    checkpoint per half-layer) against jax.vjp of the JAX package's
    _chain_ref(remat=True), with respect to x and the styles, on a
    two-block chain 8^2 -> 32^2 in f32."""
    b = 4
    blocks = _ladder(300, b, 8, [(16, 8), (8, 8)])
    x = _mk(_rng(301), (8, 8, 16, b))
    styles = [k for k in blocks[0] if k.endswith(("s0p1", "s1"))]
    cot = _mk(_rng(302), (3, 32, 32, b))

    def jchain(x, st):
        blks = tuple({**{k: jnp.asarray(v) for k, v in blk.items()}, **s}
                     for blk, s in zip(blocks, st))
        return jbc._chain_ref(x, blks, 1e-8, remat=True)

    jst = [{k: jnp.asarray(blk[k]) for k in styles} for blk in blocks]
    _, vjp = jax.vjp(jchain, jnp.asarray(x), jst)
    gx_want, gst_want = vjp(jnp.asarray(cot))

    xt = torch.tensor(x, requires_grad=True)
    tblocks = [{k: torch.tensor(v, requires_grad=k in styles)
                for k, v in blk.items()} for blk in blocks]
    out = tbc.tail_chain_bc(xt, tblocks)
    leaves = [xt] + [blk[k] for blk in tblocks for k in styles]
    got = torch.autograd.grad((out * torch.tensor(cot)).sum(), leaves)
    want = [gx_want] + [s[k] for s in gst_want for k in styles]
    for g, wv in zip(got, want):
        wv = np.asarray(wv)
        assert np.abs(g.numpy() - wv).max() <= 1e-4 * np.abs(wv).max()


WRAPPERS = {
    "up_fused": lambda x, w3, w4, nb, nb2, a, c, wr, br: tbc.up_fused(
        x, w4, nb2, a),
    "conv_fused": lambda x, w3, w4, nb, nb2, a, c, wr, br: tbc.conv_fused(
        x, w3, nb, a),
    "final_stats": lambda x, w3, w4, nb, nb2, a, c, wr, br: tbc.final_stats(
        x, w3, nb, a),
    "final_apply": lambda x, w3, w4, nb, nb2, a, c, wr, br: tbc.final_apply(
        x, w3, nb, a, c, wr, br),
    "conv_stats": lambda x, w3, w4, nb, nb2, a, c, wr, br: tbc.conv_stats(
        x, w3, nb),
    "conv_apply": lambda x, w3, w4, nb, nb2, a, c, wr, br: tbc.conv_apply(
        x, w3, nb, c),
    "conv_rgb_apply": lambda x, w3, w4, nb, nb2, a, c, wr, br:
        tbc.conv_rgb_apply(x, w3, nb, c, wr, br),
    "up_stats": lambda x, w3, w4, nb, nb2, a, c, wr, br: tbc.up_stats(
        x, w4, nb2),
    "up_apply": lambda x, w3, w4, nb, nb2, a, c, wr, br: tbc.up_apply(
        x, w4, nb2, c),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_refuses_grad_input(name):
    """Outside its autograd Function a kernel wrapper raises on an input
    that requires grad instead of returning a result with no graph; with
    grad off it runs (the plain version, on the CPU)."""
    assert set(WRAPPERS) == set(tbc.LAUNCHES)
    rng = _rng(14)
    args = [torch.tensor(a) for a in (
        _mk(rng, (4, 4, 16, 8)), _mk(rng, (3, 3, 16, 16)),
        _mk(rng, (4, 4, 16, 16)), _mk(rng, (4, 4, 16)),
        _mk(rng, (8, 8, 16)), _aff(rng, 16, 8), _aff(rng, 16, 8),
        _mk(rng, (16, 3)), _mk(rng, (3,)))]
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        WRAPPERS[name](*args)
    with torch.no_grad():
        WRAPPERS[name](*args)
