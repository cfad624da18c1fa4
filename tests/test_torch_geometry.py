"""The port's in-graph geometry (certifyingfacerecognition_torch.ops.
geometry) against the JAX package's, f32 on the CPU, on the same numpy
inputs: projections, Sigma-norms and the membership tests to 1e-5
(both run a 64-step bisection on the same bracket). One exception, with
its reason: a row that the projection leaves ON the surface (Sigma-norm
1 to f32 precision) meets proj2region's final "still outside?" test on a
knife edge, where the two frameworks' summation orders can decide it
differently; the fallback then scales that row by 1/(1 + 1e-4) in one
package only. Such rows are held to 2e-4 relative. The random streams of
the two packages differ, so sampling and initialisation are held to what
they promise: membership, and placement on the surface."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.ops import geometry as jg
from certifyingfacerecognition_torch.ops import geometry as tg

TOL = dict(rtol=1e-5, atol=1e-5)
BUDGETS = np.array([0.5, 0.5, 0.2, 0.5, 0.8])


def _dense_A(rng, d):
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return (q * rng.uniform(0.5, 4.0, d)) @ q.T


def _ellipsoids(kind, rng, d):
    """The same ellipsoid in both packages: diagonal or dense."""
    if kind == "diag":
        a = rng.uniform(1.0, 25.0, d).astype(np.float32)
        return jg.Ellipsoid.from_diag(a), tg.Ellipsoid.from_diag(a)
    A = _dense_A(rng, d)
    return jg.Ellipsoid.from_dense(A), tg.Ellipsoid.from_dense(A)


def surface_rows_close(got, want, ell):
    """got/want [B, d]: rows on the surface (Sigma-norm within 5e-4 of 1,
    the fallback's scaling included) to 2e-4 relative, the others to
    TOL."""
    n = np.asarray(ell.sq_dist(jnp.asarray(want)))
    edge = np.abs(n - 1.0) <= 5e-4
    np.testing.assert_allclose(got[~edge], want[~edge], **TOL)
    np.testing.assert_allclose(got[edge], want[edge], rtol=2e-4, atol=1e-6)


def _proj_mat(rng, d, k):
    q, _ = np.linalg.qr(rng.standard_normal((d, k)))
    return (q @ q.T).astype(np.float32)


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_proj_ellipse_and_norms_match_jax(kind):
    rng = np.random.default_rng(0)
    d = 16
    je, te = _ellipsoids(kind, rng, d)
    y = (rng.standard_normal((12, d)) * 0.8).astype(np.float32)
    np.testing.assert_allclose(
        tg.proj_ellipse(torch.tensor(y), te).numpy(),
        np.asarray(jg.proj_ellipse(jnp.asarray(y), je)), **TOL)
    np.testing.assert_allclose(te.sq_dist(torch.tensor(y)).numpy(),
                               np.asarray(je.sq_dist(jnp.asarray(y))),
                               rtol=1e-5)
    np.testing.assert_allclose(te.mat().numpy(), np.asarray(je.mat()),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(te.cholesky_inv_t().numpy(),
                               np.asarray(je.cholesky_inv_t()), **TOL)


@pytest.mark.parametrize("kind,to_subs,on_surface",
                         [("diag", False, False), ("diag", False, True),
                          ("diag", True, False), ("dense", True, False),
                          ("dense", True, True), ("dense", False, False)])
def test_proj2region_matches_jax(kind, to_subs, on_surface):
    rng = np.random.default_rng(1)
    d = 16
    je, te = _ellipsoids(kind, rng, d)
    pm = _proj_mat(rng, d, 5)
    v = (rng.standard_normal((10, d)) * 0.9).astype(np.float32)
    want = jg.proj2region(jnp.asarray(v), jnp.asarray(pm), je,
                          to_subs=to_subs, on_surface=on_surface)
    got = tg.proj2region(torch.tensor(v), torch.tensor(pm), te,
                         to_subs=to_subs, on_surface=on_surface)
    surface_rows_close(got.numpy(), np.asarray(want), je)
    assert tg.in_ellps(got, te) == jg.in_ellps(want, je)
    if to_subs:
        assert tg.in_subs(got, torch.tensor(pm)) and \
            jg.in_subs(want, jnp.asarray(pm))


def test_sq_distances_and_membership_match_jax():
    rng = np.random.default_rng(2)
    d = 12
    A = _dense_A(rng, d).astype(np.float32)
    a = rng.uniform(0.5, 3.0, d).astype(np.float32)
    x, y = (rng.standard_normal((7, d)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tg.sq_distance(torch.tensor(A), torch.tensor(x),
                       torch.tensor(y)).numpy(),
        np.asarray(jg.sq_distance(jnp.asarray(A), jnp.asarray(x),
                                  jnp.asarray(y))), **TOL)
    np.testing.assert_allclose(
        tg.sq_distance_diag(torch.tensor(a), torch.tensor(x)).numpy(),
        np.asarray(jg.sq_distance_diag(jnp.asarray(a), jnp.asarray(x))),
        rtol=1e-5)
    je, te = jg.Ellipsoid.from_diag(a), tg.Ellipsoid.from_diag(a)
    pm = _proj_mat(rng, d, 4)
    for scale in (0.1, 0.3, 3.0):
        v = x * scale
        assert tg.in_ellps(torch.tensor(v), te) == \
            jg.in_ellps(jnp.asarray(v), je)
        inside = v @ pm
        for w in (v, inside):
            assert tg.in_subs(torch.tensor(w), torch.tensor(pm)) == \
                jg.in_subs(jnp.asarray(w), jnp.asarray(pm))


def test_region_ellipsoids_match_jax():
    """RegionMatrices' reduced (diagonal) and dense ellipsoids equal the
    JAX package's."""
    rt, rj = tg.get_all_matrices(), jg.get_all_matrices()
    np.testing.assert_array_equal(rt.red_ellipse.diag.numpy(),
                                  np.asarray(rj.red_ellipse.diag))
    np.testing.assert_allclose(rt.ellipse.eigvals.numpy(),
                               np.asarray(rj.ellipse.eigvals), rtol=1e-6)
    np.testing.assert_allclose(rt.ellipse.mat().numpy(),
                               np.asarray(rj.ellipse.mat()), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_sample_ellipsoid_inside(kind):
    rng = np.random.default_rng(3)
    _, te = _ellipsoids(kind, rng, 8)
    s = tg.sample_ellipsoid(torch.Generator().manual_seed(0), te, 2000)
    assert s.shape == (2000, 8)
    d = te.sq_dist(s)
    assert tg.in_ellps(s, te) and float(d.max()) <= 1.0
    # uniform in the ball: the squared norm is U^(2/d), median 0.5^(1/4)
    assert abs(float(d.median()) - 0.5 ** 0.25) < 0.03


@pytest.mark.parametrize("lin_comb,on_surface", [(True, True),
                                                 (True, False),
                                                 (False, True)])
def test_init_deltas_membership_and_surface(lin_comb, on_surface):
    rng = np.random.default_rng(4)
    red = (1.0 / BUDGETS ** 2).astype(np.float32)
    pm = _proj_mat(rng, 512, 5)
    te = tg.Ellipsoid.from_diag(red if lin_comb else np.ones(512))
    gen = torch.Generator().manual_seed(1)
    d = tg.init_deltas(gen, 64, te, proj_mat=torch.tensor(pm),
                       lin_comb=lin_comb, on_surface=on_surface)
    assert d.shape == (64, 5 if lin_comb else 512)
    assert tg.in_ellps(d, te)
    if not lin_comb:
        assert tg.in_subs(d, torch.tensor(pm))
    n = te.sq_dist(d)
    if on_surface and lin_comb:
        # proj_to_surface's +1e-4 guard: just inside the surface
        assert float((1.0 - n).abs().max()) < 1e-3
    elif not on_surface:
        assert float(n.min()) < 0.9
    z = tg.init_deltas(gen, 3, te, random_init=False, lin_comb=lin_comb)
    assert z.shape == (3, 5 if lin_comb else 512) and not z.any()
    jz = jg.init_deltas(jax.random.PRNGKey(0), 3,
                        jg.Ellipsoid.from_diag(red), random_init=False,
                        lin_comb=lin_comb)
    assert jz.shape == tuple(z.shape)
