"""The port's attack layer (certifyingfacerecognition_torch.attacks)
against the JAX package's, f32 on the CPU, on the same numpy inputs.

* compute_loss for every loss type: value and gradient to rtol 1e-5
  (atol 1e-6 on the gradients).
* find_adversaries_pgd on the JAX tests' toy problem (tests/
  test_attacks.py:28-68), for SGD, Adam and RMSProp, with zero initial
  deltas and, separately, with the JAX package's own random initial
  deltas handed to the port: best_deltas, found and magnitudes equal to
  JAX's within 1e-5. The PGD deltas end on the ellipsoid's surface, where
  proj2region's final fallback can fire in one package only (see
  tests/test_torch_geometry.py); such rows are held to 2e-4 relative.
* A run whose samples start at distance exactly 0 from their own gallery
  entry: the gradient there is finite (the cdist subgradient repair).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.attacks import losses as jL
from certifyingfacerecognition_tpu.attacks import pgd as jpgd
from certifyingfacerecognition_tpu.ops import geometry as jg
from certifyingfacerecognition_tpu.ops.distances import cdist as jcdist
from certifyingfacerecognition_torch.attacks import losses as tL
from certifyingfacerecognition_torch.attacks import pgd as tpgd
from certifyingfacerecognition_torch.ops import geometry as tg
from certifyingfacerecognition_torch.ops.distances import cdist as tcdist

BUDGETS = np.array([0.5, 0.5, 0.2, 0.5, 0.8])


@pytest.mark.parametrize("loss_type", ["away", "nearest", "diff", "xent",
                                       "dlr"])
def test_compute_loss_value_and_gradient_match_jax(loss_type):
    rng = np.random.default_rng(0)
    dists = rng.uniform(5, 40, (6, 30)).astype(np.float32)
    labels = np.array([0, 3, 7, 7, 1, 29])
    use_probs = loss_type != "dlr"

    def jloss(d):
        return jL.compute_loss(d, jnp.asarray(labels), loss_type=loss_type,
                               use_probs=use_probs)

    want, gwant = jax.value_and_grad(jloss)(jnp.asarray(dists))
    dt = torch.tensor(dists, requires_grad=True)
    got = tL.compute_loss(dt, torch.tensor(labels), loss_type=loss_type,
                          use_probs=use_probs)
    (gg,) = torch.autograd.grad(got, dt)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(gg.numpy(), np.asarray(gwant), rtol=1e-5,
                               atol=1e-6)


def test_per_sample_losses_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((5, 9)).astype(np.float32)
    y = np.array([0, 2, 8, 4, 4])
    yt = np.array([1, 3, 0, 5, 6])
    lj, lt = jnp.asarray(logits), torch.tensor(logits)
    for got, want in (
            (tL.dlr_loss(lt, torch.tensor(y)), jL.dlr_loss(lj, jnp.asarray(y))),
            (tL.dlr_loss_targeted(lt, torch.tensor(y), torch.tensor(yt)),
             jL.dlr_loss_targeted(lj, jnp.asarray(y), jnp.asarray(yt))),
            (tL.ce_loss(lt, torch.tensor(y)), jL.ce_loss(lj, jnp.asarray(y)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def _toy_problem():
    """The JAX tests' toy problem: 5 orthonormal directions in R^512, the
    first along the boundary between gallery identities 0 and 1, and four
    latents just on identity 0's side. Returns numpy arrays."""
    rng = np.random.default_rng(123)
    centers = rng.standard_normal((12, 512)).astype(np.float32)
    a, b = centers[0], centers[1]
    bdir = (b - a) / np.linalg.norm(b - a)
    d = rng.standard_normal((512, 5))
    d[:, 0] = bdir
    q, _ = np.linalg.qr(d)
    dirs = q[:, :5].astype(np.float32)
    if np.dot(dirs[:, 0], bdir) < 0:
        dirs[:, 0] *= -1
    lats = np.stack([(a + b) / 2 - 0.05 * bdir * (i + 1)
                     for i in range(4)]).astype(np.float32)
    return centers, dirs, lats


def _regions(dirs):
    red = (1.0 / BUDGETS ** 2).astype(np.float32)
    pm = dirs @ dirs.T
    rj = jg.RegionMatrices(
        proj_mat=jnp.asarray(pm),
        ellipse=jg.Ellipsoid.from_diag(np.ones(512, np.float32)),
        dirs=jnp.asarray(dirs), dirs_inv=jnp.asarray(np.linalg.pinv(dirs)),
        red_ellipse=jg.Ellipsoid.from_diag(red),
        red_ellipse_diag=jnp.asarray(red),
        red_ellipse_diag_inv=jnp.asarray(1.0 / red))
    f = torch.tensor
    rt = tg.RegionMatrices(
        proj_mat=f(pm), ellipse_mat=torch.eye(512),
        ellipse=tg.Ellipsoid.from_diag(np.ones(512, np.float32)),
        dirs=f(dirs), dirs_inv=f(np.linalg.pinv(dirs)),
        red_ellipse=tg.Ellipsoid.from_diag(red), red_ellipse_diag=f(red),
        red_ellipse_diag_inv=f(1.0 / red))
    return rj, rt


def _pgd_both(gallery, lats, labels, dirs, opt, random_init, iters=6,
              restarts=2):
    rj, rt = _regions(dirs)
    key = jax.random.PRNGKey(0)
    kw = dict(opt_name=opt, lr=100.0, iters=iters, loss_type="xent",
              restarts=restarts, random_init=random_init)
    jres = jpgd.find_adversaries_pgd(
        lambda w: jcdist(w, jnp.asarray(gallery)), jnp.asarray(lats),
        jnp.asarray(labels), key, rj, **kw)
    init = None
    if random_init:
        # the JAX package's own initial deltas, restart by restart
        init = torch.tensor(np.stack([np.asarray(jg.init_deltas(
            k, len(lats), rj.red_ellipse, random_init=True))
            for k in jax.random.split(key, restarts)]))
    tres = tpgd.find_adversaries_pgd(
        lambda w: tcdist(w, torch.tensor(gallery)), torch.tensor(lats),
        torch.tensor(labels), torch.Generator().manual_seed(0), rt,
        init=init, **kw)
    return jres, tres, rj


def _assert_pgd_equal(jres, tres, rj):
    np.testing.assert_array_equal(tres.found.numpy(), np.asarray(jres.found))
    want = np.asarray(jres.best_deltas)
    got = tres.best_deltas.numpy()
    n = np.asarray(rj.red_ellipse.sq_dist(jnp.asarray(want)))
    edge = np.abs(n - 1.0) <= 5e-4
    np.testing.assert_allclose(got[~edge], want[~edge], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[edge], want[edge], rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(tres.magnitudes.numpy(),
                               np.asarray(jres.magnitudes), rtol=5e-4,
                               atol=1e-5)


@pytest.mark.parametrize("opt", ["SGD", "Adam", "RMSProp"])
@pytest.mark.parametrize("random_init", [False, True])
def test_pgd_matches_jax_on_toy_problem(opt, random_init):
    centers, dirs, lats = _toy_problem()
    labels = np.zeros(4, np.int64)
    jres, tres, rj = _pgd_both(centers, lats, labels, dirs, opt, random_init)
    _assert_pgd_equal(jres, tres, rj)
    tpgd.assert_deltas_feasible(tres.best_deltas, _regions(dirs)[1])


def test_pgd_zero_distance_start_has_finite_gradient():
    """Zero initial deltas on latents that ARE their own gallery entries:
    distance exactly 0 at the label, where sqrt's gradient is inf. The
    port's cdist takes the JAX package's subgradient 0 there, so the
    gradient is finite and the attack matches JAX's."""
    centers, dirs, lats = _toy_problem()
    # multiples of 1/8: the matmul expansion of the distance is exact, so
    # each latent is at distance exactly 0 from its own gallery row
    lats = np.round(lats * 8) / 8
    gallery = np.concatenate([lats, centers])
    labels = np.arange(4)
    d = torch.zeros((4, 5), requires_grad=True)
    dists = tcdist(torch.tensor(lats) + d @ torch.tensor(dirs).t(),
                   torch.tensor(gallery))
    assert (dists[np.arange(4), labels] == 0).all()
    (g,) = torch.autograd.grad(tL.compute_loss(dists, torch.tensor(labels),
                                               loss_type="xent"), d)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    jres, tres, rj = _pgd_both(gallery, lats, labels, dirs, "SGD", False,
                               iters=3, restarts=1)
    assert torch.isfinite(tres.best_deltas).all()
    _assert_pgd_equal(jres, tres, rj)
