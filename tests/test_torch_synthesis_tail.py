"""The port's chain-tail plain versions (certifyingfacerecognition_torch.
ops.synthesis_tail_bc, taken by the wrappers for CPU tensors) against the
JAX package's Pallas functions run in interpret mode on the CPU.

Tolerances: f32 rtol=atol=5e-4 (the JAX package's own bound for these
kernels). bf16 rtol=atol=3e-2; measured worst case at these shapes: 0.0
for the activations and images (the plain versions round at the same
points as the Pallas kernels), and the f32 sums agree to f32 summation
order (<1e-6 relative)."""

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
