"""The port's gallery head (certifyingfacerecognition_torch.ops.distances)
against the JAX package's, f32 on the CPU: distances at rtol=1e-5 (atol
1e-4 on squared distances ~1e3), decisions exactly, including planted
exact ties and non-finite rows."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from certifyingfacerecognition_tpu.ops import distances as jd
from certifyingfacerecognition_torch.ops import distances as td


def _data(seed, b=6, n=300):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 512)).astype(np.float32),
            rng.standard_normal((n, 512)).astype(np.float32))


def test_distance_matrices_match_jax():
    x, g = _data(0)
    for method in ("insightface", "facenet"):
        np.testing.assert_allclose(
            td.cdist(torch.tensor(x), torch.tensor(g), method).numpy(),
            np.asarray(jd.cdist(jnp.asarray(x), jnp.asarray(g), method)),
            rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(
            td.pairwise_dists(torch.tensor(x), torch.tensor(g[:6]),
                              method).numpy(),
            np.asarray(jd.pairwise_dists(jnp.asarray(x), jnp.asarray(g[:6]),
                                         method)), rtol=1e-5, atol=1e-5)
    d = np.random.default_rng(1).uniform(10, 30, (3, 7)).astype(np.float32)
    np.testing.assert_allclose(
        td.probs_from_dists(torch.tensor(d)).numpy(),
        np.asarray(jd.probs_from_dists(jnp.asarray(d))), rtol=1e-5)


def test_nearest_refined_matches_jax_with_planted_ties():
    x, g = _data(2)
    dup = (x[0] + 1e-3 * np.random.default_rng(3).standard_normal(512)
           ).astype(np.float32)
    g[250] = dup
    g[40] = dup        # exact tie: the lower index must win
    g[77] = x[1]       # exact match: distance 0
    dt, it = td.nearest_refined(torch.tensor(x), torch.tensor(g))
    dj, ij = jd.nearest_refined(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert int(it[0]) == 40 and int(it[1]) == 77
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-4)
    want = ((x.astype(np.float64)[:, None] - g[None]) ** 2).sum(-1).argmin(1)
    np.testing.assert_array_equal(it.numpy(), want)
    for method in ("facenet",):
        np.testing.assert_array_equal(
            td.argmin_dist_refined(torch.tensor(x), torch.tensor(g),
                                   method).numpy(),
            np.asarray(jd.argmin_dist_refined(jnp.asarray(x), jnp.asarray(g),
                                              method)))


def test_nearest_refined_nonfinite_query_stays_in_range():
    x = np.full((2, 512), np.nan, np.float32)
    x[1] = np.random.default_rng(4).standard_normal(512).astype(np.float32)
    g = np.random.default_rng(5).standard_normal((100, 512)).astype(
        np.float32)
    _, idx = td.nearest_refined(torch.tensor(x), torch.tensor(g))
    assert 0 <= int(idx[0]) < 100
    want = ((x[1:2, None, :] - g[None]) ** 2).sum(-1).argmin(1)[0]
    assert int(idx[1]) == want
    _, jidx = jd.nearest_refined(jnp.asarray(x), jnp.asarray(g))
    assert int(idx[1]) == int(jidx[1])


def test_cdist_gradient_at_zero_distance_matches_jax():
    """A gallery row equal to the query (distance exactly 0; entries are
    multiples of 1/8, so the matmul expansion is exact): the port's
    gradient equals jax.grad of the JAX cdist, which takes the
    subgradient 0 there, and is finite; the other entries agree to
    rtol 1e-5."""
    x, g = _data(6, b=3, n=40)
    x = np.round(x * 8) / 8
    g[5], g[17] = x[0], x[2]
    cot = np.random.default_rng(7).standard_normal((3, 40)).astype(
        np.float32)
    want = jax.grad(lambda x: jnp.sum(jd.cdist(x, jnp.asarray(g))
                                      * cot))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    d = td.cdist(xt, torch.tensor(g))
    assert d[0, 5] == 0 and d[2, 17] == 0
    (got,) = torch.autograd.grad((d * torch.tensor(cot)).sum(), xt)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the zero entry contributes nothing: drop it and the gradient holds
    cot0 = cot.copy()
    cot0[0, 5] = cot0[2, 17] = 0.0
    (got0,) = torch.autograd.grad((td.cdist(xt, torch.tensor(g))
                                   * torch.tensor(cot0)).sum(), xt)
    np.testing.assert_array_equal(got0.numpy(), got.numpy())
