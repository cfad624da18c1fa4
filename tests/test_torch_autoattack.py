"""The port's AutoAttack family (certifyingfacerecognition_torch.attacks.
apgd / fab / square / autoattack / checks) against the JAX package's, f32
on the CPU, on tests/test_torch_attacks.py's toy problem (its gallery
centres and directions, its four latents near the boundary between
identities 0 and 1) with a fifth latent deep in identity 0's region.

JAX and torch draw different random streams, so each test builds the JAX
package's own draws with its key discipline (fold_in(key, counter) for
APGD, fold_in(fold_in(key, t), c) for APGD-t and FAB-t, split for Square
and for the attacks of a preset) and injects them into the port. The
JAX package's init_deltas is jitted for these tests (its eager bisection
costs a second a call); the draws handed to the port come from the same
jitted function.

* APGD-ce, APGD-dlr and APGD-t (6 iterations): deltas to 1e-5, success
  equal, magnitudes to 1e-5 relative (the f32 rounding of a product of
  deltas that agree to 1e-5). Longer APGD runs are held to the
  same decisions and magnitudes, but not their deltas: on this problem
  the loss hardly depends on four of the five directions (its gradient
  there is ~1e-4 of the boundary direction's), the iterates move along
  them with loss changes below f32 resolution, and APGD's best-loss pick
  among such iterates follows each framework's rounding (measured at 7
  iterations: x_best 3e-4 apart in those components, loss_best 7e-7).
  The boundary component is still held to 1e-5 there.
* FAB-t: success equal; deltas to 2.5e-5 and magnitudes to 1.5e-5
  relative, a tolerance derived from the conditioning of its step, which
  a float64 run of both packages' FAB body measures (the two agree there
  to 1e-12; test_fab_targeted_matches_jax says why).
* Square: success equal; deltas to 1e-5, except rows on the ellipsoid's
  surface, where proj2region's final surface fallback can fire in one
  package only (tests/test_torch_geometry.py): those to 2e-4 relative,
  and the magnitudes to 5e-4 relative, as tests/test_torch_attacks.py
  holds PGD.
* run_standard_evaluation for each preset (standard, rand, plus; gallery
  of the first 4 centres, so 3 targets): the same attack order and
  robust-accuracy dict, the same kept deltas (1e-5), y_adv and success;
  make_standard_evaluation's run gives the closure path's result;
* run_attack's defaults (apgd-ce's 100 x 1 and its warning, fab raising);
* the checks on the JAX tests' model (tests/test_checks.py) and
  check_retracing's False for an eager callable.

Torch runs one intra-op thread per process: the suite runs in several
pytest-xdist workers that share the machine's cores.
"""

import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.attacks import apgd as japgd
from certifyingfacerecognition_tpu.attacks import autoattack as jaa
from certifyingfacerecognition_tpu.attacks import checks as jchecks
from certifyingfacerecognition_tpu.attacks import fab as jfab
from certifyingfacerecognition_tpu.attacks import square as jsq
from certifyingfacerecognition_tpu.ops import geometry as jg
from certifyingfacerecognition_tpu.ops.distances import cdist as jcdist
from certifyingfacerecognition_torch.attacks import apgd as tapgd
from certifyingfacerecognition_torch.attacks import autoattack as taa
from certifyingfacerecognition_torch.attacks import checks as tchecks
from certifyingfacerecognition_torch.attacks import fab as tfab
from certifyingfacerecognition_torch.attacks import square as tsq
from certifyingfacerecognition_torch.ops import geometry as tg
from certifyingfacerecognition_torch.ops.distances import cdist as tcdist
from test_torch_attacks import BUDGETS, _regions, _toy_problem

torch.set_num_threads(1)

HI = jax.lax.Precision.HIGHEST
KEY = jax.random.PRNGKey(3)


def _latents():
    """The toy problem's four latents plus a fifth deep in identity 0's
    region (3 along the boundary direction, six times its budget), which
    only the minimum-norm FAB breaks: every attack of a preset then runs."""
    centers, _, lats = _toy_problem()
    a, b = centers[0], centers[1]
    bdir = (b - a) / np.linalg.norm(b - a)
    return np.concatenate([lats, ((a + b) / 2 - 3.0 * bdir)[None]]
                          ).astype(np.float32)


def _toy(n_gallery=12):
    """(jax logits_fn, torch logits_fn, labels, jax region, torch region)
    on _latents(), with the first ``n_gallery`` centres as the gallery."""
    centers, dirs, _ = _toy_problem()
    centers, lats = centers[:n_gallery], _latents()
    rj, rt = _regions(dirs)
    gj, lj = jnp.asarray(centers), jnp.asarray(lats)
    gt, lt = torch.tensor(centers), torch.tensor(lats)

    def jlogits(d):
        return -jcdist(lj + jnp.dot(d, rj.dirs.T, precision=HI), gj)

    def tlogits(d):
        return -tcdist(lt + tg.matmul_f32(d, rt.dirs.t()), gt)

    return jlogits, tlogits, np.zeros(5, np.int64), rj, rt


@pytest.fixture(scope="module")
def toy():
    return _toy()


# -- the JAX package's draws, key by key --------------------------------

_INIT_FNS = {}


def _jit_init_deltas(key, n_vecs, ell, proj_mat=None, **kw):
    """jg.init_deltas, jitted once per (shape, ellipsoid, flags)."""
    k = (n_vecs, id(ell), proj_mat is None, tuple(sorted(kw.items())))
    if k not in _INIT_FNS:
        _INIT_FNS[k] = jax.jit(lambda key: _JAX_INIT_DELTAS(
            key, n_vecs, ell, proj_mat, **kw))
    return _INIT_FNS[k](key)


_JAX_INIT_DELTAS = jg.init_deltas


@pytest.fixture(autouse=True)
def _jitted_jax_draws(monkeypatch):
    monkeypatch.setattr(jg, "init_deltas", _jit_init_deltas)


def _init(key, rj):
    return np.asarray(_jit_init_deltas(key, 5, rj.red_ellipse,
                                       lin_comb=True, on_surface=True))


def apgd_draws(key, rj, n_restarts):
    return torch.tensor(np.stack([_init(jax.random.fold_in(key, c), rj)
                                  for c in range(n_restarts)]))


def targeted_draws(key, rj, n_target, n_restarts):
    return torch.tensor(np.stack([np.stack([
        _init(jax.random.fold_in(jax.random.fold_in(key, t), c), rj)
        for c in range(n_restarts)]) for t in range(2, n_target + 2)]))


def square_draws(key, rj, n_iter, n_restarts, b=5):
    k = rj.red_ellipse_diag.shape[0]
    inits, coords, signs = [], [], []
    for rk in jax.random.split(key, n_restarts):
        k0, k1 = jax.random.split(rk)
        inits.append(np.asarray(_jit_init_deltas(
            k0, b, rj.red_ellipse, None, random_init=True, lin_comb=True,
            on_surface=True)))
        cs, ss = [], []
        for it in jax.random.split(k1, n_iter):
            kc, ks = jax.random.split(it)
            cs.append(np.asarray(jax.random.randint(kc, (b,), 0, k)))
            ss.append(np.asarray(jax.random.rademacher(ks, (b,),
                                                       jnp.float32)))
        coords.append(np.stack(cs))
        signs.append(np.stack(ss))
    return tuple(torch.tensor(np.stack(a)) for a in (inits, coords, signs))


def _assert_result_equal(got, want, atol=1e-5, mag_rtol=1e-5):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=mag_rtol, atol=1e-7)


_GEN = torch.Generator().manual_seed(0)      # unused: every draw injected


@pytest.mark.parametrize("loss", ["ce", "dlr"])
def test_apgd_matches_jax(toy, loss):
    jlogits, tlogits, labels, rj, rt = toy
    want = japgd.apgd_attack(jlogits, jnp.asarray(labels), KEY, rj,
                             loss=loss, n_iter=6, n_restarts=2)
    got = tapgd.apgd_attack(tlogits, torch.tensor(labels), _GEN, rt,
                            loss=loss, n_iter=6, n_restarts=2,
                            init=apgd_draws(KEY, rj, 2))
    _assert_result_equal(got, want)
    assert got.success.any() and not got.success.all()


def test_apgd_long_run_decisions_match_jax(toy):
    """20 iterations: success and magnitudes as above, the boundary
    direction's component to 1e-5 (see the module docstring)."""
    jlogits, tlogits, labels, rj, rt = toy
    want = japgd.apgd_attack(jlogits, jnp.asarray(labels), KEY, rj,
                             loss="ce", n_iter=20, n_restarts=1)
    got = tapgd.apgd_attack(tlogits, torch.tensor(labels), _GEN, rt,
                            loss="ce", n_iter=20, n_restarts=1,
                            init=apgd_draws(KEY, rj, 1))
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    np.testing.assert_allclose(got.magnitudes.numpy(),
                               np.asarray(want.magnitudes), rtol=1e-5)
    np.testing.assert_allclose(got.deltas[:, 0].numpy(),
                               np.asarray(want.deltas)[:, 0], rtol=0,
                               atol=1e-5)


def test_apgd_targeted_matches_jax(toy):
    jlogits, tlogits, labels, rj, rt = toy
    want = japgd.apgd_targeted_attack(jlogits, jnp.asarray(labels), KEY, rj,
                                      n_iter=6, n_restarts=1,
                                      n_target_classes=3)
    got = tapgd.apgd_targeted_attack(tlogits, torch.tensor(labels), _GEN,
                                     rt, n_iter=6, n_restarts=1,
                                     n_target_classes=3,
                                     init=targeted_draws(KEY, rj, 3, 1))
    _assert_result_equal(got, want)
    assert got.success.any()


# FAB-t's f32 tolerances, derived in test_fab_step_float64_matches_jax:
# row 0's adversary moves by at most FAB_SENSITIVITY (its magnitude by
# FAB_MAG_SENSITIVITY relative) per unit roundoff (2^-24) of relative error
# in the logits, and each package's f32 logits are off by up to the unit
# roundoffs that test reads against float64 along the run (about 6.4 for
# JAX, 5.9 for the port on one CPU), so the two may part by their sum
# times the sensitivity.
FAB_SENSITIVITY = 3.29e-6
FAB_MAG_SENSITIVITY = 2.04e-6
FAB_ATOL = 2.5e-5          # <= FAB_SENSITIVITY * (the two readings' sum)
FAB_MAG_RTOL = 1.5e-5      # <= FAB_MAG_SENSITIVITY * (the same sum)


def test_fab_targeted_matches_jax(toy):
    """Success equal; deltas to FAB_ATOL = 2.5e-5 and magnitudes to
    FAB_MAG_RTOL = 1.5e-5 relative, not the 1e-5 of the other attacks.

    Why: both packages run the same FAB body in the same order (in float64
    they agree to 1e-13, test_fab_step_float64_matches_jax), but the step
    amplifies the f32 rounding of the logits. The logits are distances by
    the matmul expansion sqrt(|x|^2 + |y|^2 - 2 x.y), whose 512-term
    reductions each library rounds its own way, and the step linearises
    their difference diffy = 16.501 - 16.182 = 0.319 (row 0, first
    iteration; a cancellation of 103x). FAB-t's projection quirk then
    roughly doubles the iterate each step. In float64, one unit roundoff of
    relative error in row 0's logits (worst-case signs, both iterations
    that lead to its adversary) moves the adversary by FAB_SENSITIVITY =
    3.29e-6 and its magnitude by FAB_MAG_SENSITIVITY = 2.04e-6 relative.
    Measured against float64 at the inputs of those two iterations (every
    row's logits: how far an f32 logit of this problem is off), the JAX
    package's f32 logits are off by up to 6.40 unit roundoffs and the
    port's by up to 5.92 on one CPU (row 0's own: 3.27 and 4.64 there; the
    JAX CPU code rounds its reductions differently on another host, which
    is why the 1e-5 of the other attacks held on one machine and failed on
    another), so the two may part by 3.29e-6 * 12.3 = 4.1e-5 in the deltas
    and 2.5e-5 in the magnitudes. Observed on one CPU: row 0's first
    component 1.1162617 (JAX) against 1.1162477 (port), float64 1.1162594:
    1.41e-5 apart, magnitudes 8.75e-6 relative."""
    jlogits, tlogits, labels, rj, rt = toy
    want = jfab.fab_targeted(jlogits, jnp.asarray(labels), KEY, rj,
                             n_iter=6, n_restarts=2, n_target_classes=2)
    got = tfab.fab_targeted(tlogits, torch.tensor(labels), _GEN, rt,
                            n_iter=6, n_restarts=2, n_target_classes=2,
                            init=targeted_draws(KEY, rj, 2, 2))
    _assert_result_equal(got, want, atol=FAB_ATOL, mag_rtol=FAB_MAG_RTOL)
    assert got.success.all()      # minimum-norm: the fifth latent too


def _jax_fab_iteration(logits_fn, x1, x0, labels, la_target, mat, mat_inv,
                       alpha_max=0.1, eta=1.05, beta=0.9):
    """The body of the JAX package's fab_targeted (its scan step), built
    from the package's own _projection_lsigma2 and sq_distance_diag in
    its order: (candidate, is_adv, next iterate)."""
    rows = jnp.arange(x1.shape[0])

    def f(x):
        y = logits_fn(x)
        diffy = -(y[rows, labels] - y[rows, la_target])
        return jnp.sum(diffy), diffy

    (_, df), dg = jax.value_and_grad(f, has_aux=True)(x1)
    b = -df + jg.sq_distance_diag(mat, dg, x1)
    d1 = jfab._projection_lsigma2(x1, dg, b, mat_inv)
    d2 = jfab._projection_lsigma2(x0, dg, b, mat_inv)
    a1 = jnp.maximum(jnp.sqrt(jnp.maximum(jg.sq_distance_diag(mat, d1),
                                          0.0)), 1e-8)
    a2 = jnp.maximum(jnp.sqrt(jnp.maximum(jg.sq_distance_diag(mat, d2),
                                          0.0)), 1e-8)
    alpha = jnp.clip(a1 / (a1 + a2), 0.0, alpha_max)[:, None]
    cand = (x1 + eta * d1) * (1.0 - alpha) + (x0 + eta * d2) * alpha
    cand = jnp.where(jnp.isnan(jnp.sum(cand, axis=1))[:, None], x1, cand)
    is_adv = jnp.argmax(logits_fn(cand), axis=1) != labels
    return cand, is_adv, jnp.where(is_adv[:, None], x0 + (cand - x0) * beta,
                                   cand)


@pytest.mark.parametrize("n_iter", [2, 3])
def test_jax_fab_iteration_is_the_packages_body(toy, n_iter):
    """_jax_fab_iteration, the copy of the JAX package's FAB body that
    test_fab_step_float64_matches_jax runs in float64, gives the package's
    fab_targeted result in f32 (one target, one restart, the package's
    draw): each row's minimum-norm adversarial candidate of n_iter
    iterations, zero where none is. Success exactly, deltas to FAB_ATOL:
    the copy is the body run eagerly, the package runs it in a scan, and
    the f32 logits of the two round apart as the two packages' do (7e-7
    apart on one CPU); a changed step rule moves them by far more. At one
    iteration no row is adversarial yet."""
    jlogits, _, labels, rj, _ = toy
    want = jfab.fab_targeted(jlogits, jnp.asarray(labels), KEY, rj,
                             n_iter=n_iter, n_restarts=1, n_target_classes=1)
    mat, mat_inv = rj.red_ellipse_diag, rj.red_ellipse_diag_inv
    la = jnp.argsort(jlogits(jnp.zeros((5, 5))), axis=1)[:, -2]
    x1 = jnp.asarray(targeted_draws(KEY, rj, 1, 1)[0, 0].numpy())
    x0 = jnp.zeros_like(x1)
    best = np.zeros((5, 5), np.float32)
    best_t = np.full(5, np.inf, np.float32)
    for _ in range(n_iter):
        cand, is_adv, x1 = _jax_fab_iteration(jlogits, x1, x0,
                                              jnp.asarray(labels), la, mat,
                                              mat_inv)
        t = np.sqrt(np.maximum(np.asarray(jg.sq_distance_diag(mat, cand)),
                               0.0))
        take = np.asarray(is_adv) & (t < best_t)
        best[take], best_t[take] = np.asarray(cand)[take], t[take]
    np.testing.assert_array_equal(np.asarray(want.success),
                                  np.isfinite(best_t))
    assert np.isfinite(best_t).any()
    np.testing.assert_allclose(np.asarray(want.deltas), best, rtol=0,
                               atol=FAB_ATOL)


def _ulps(y32, y64):
    """The largest relative error of f32 logits against float64, in unit
    roundoffs (2^-24)."""
    return float((np.abs(y32 - y64) / np.abs(y64)).max() / 2.0 ** -24)


def test_fab_step_float64_matches_jax(toy):
    """The FAB iterations behind row 0's adversary (target class 2, restart
    0, iterations 1 and 2, from the JAX package's draw) in float64: the
    port's _fab_iteration and the JAX package's body agree to 1e-12 at
    every iteration of every (target, restart) run; row 0's candidate lies
    between the two packages' f32 values; and the conditioning that
    FAB_ATOL / FAB_MAG_RTOL are derived from (test_fab_targeted_matches_jax)
    is as stated: the worst-case change of row 0's adversary per unit
    roundoff of relative error in the logits, by finite differences. The
    logit errors it is multiplied by are read here: each package's f32
    logits against float64 at the inputs of the two iterations, the
    tolerances at most the sensitivity times their sum."""
    jlogits, tlogits32, labels, rj, _ = toy
    centers, dirs, _ = _toy_problem()
    centers, lats = centers.astype(np.float64), _latents().astype(np.float64)
    dirs, red = dirs.astype(np.float64), 1.0 / BUDGETS ** 2
    draws = targeted_draws(KEY, rj, 2, 2).double()          # [T, R, B, k]
    order = np.argsort(np.asarray(jlogits(jnp.zeros((5, 5)))), axis=1,
                       kind="stable")
    tl, tg_, tdirs = (torch.tensor(a) for a in (lats, centers, dirs))
    tmat, tmat_inv = torch.tensor(red), torch.tensor(1.0 / red)
    tlabels = torch.tensor(labels)

    def tlogits(d, e=0.0):
        return -tcdist(tl + tg.matmul_f32(d, tdirs.t()), tg_) * (1.0 + e)

    def port_run(d0, la, e=(0.0, 0.0), inputs=None):
        x0, x1, out = torch.zeros_like(d0), d0, []
        for k in range(2):
            if inputs is not None:
                inputs.append(x1)
            cand, _, x1 = tfab._fab_iteration(
                partial(tlogits, e=e[k]), x1, x0, tlabels, la, tmat,
                tmat_inv, alpha_max=0.1, eta=1.05, beta=0.9)
            out.append(cand.numpy())
        return out

    with jax.enable_x64(True):
        jl, jgal, jdirs = (jnp.asarray(a) for a in (lats, centers, dirs))

        def jlogits64(d):
            return -jcdist(jl + jnp.dot(d, jdirs.T, precision=HI), jgal)

        for t, tc in enumerate((2, 3)):
            la = order[:, -tc]
            for r in range(2):
                x1 = jnp.asarray(draws[t, r].numpy())
                x0 = jnp.zeros_like(x1)
                got = port_run(draws[t, r], torch.tensor(la))
                for k in range(2):
                    cand, _, x1 = _jax_fab_iteration(
                        jlogits64, x1, x0, jnp.asarray(labels),
                        jnp.asarray(la), jnp.asarray(red),
                        jnp.asarray(1.0 / red))
                    assert np.asarray(cand).dtype == np.float64
                    np.testing.assert_allclose(got[k], np.asarray(cand),
                                               rtol=0, atol=1e-12)

    la, inputs = torch.tensor(order[:, -2]), []
    base = port_run(draws[0, 0], la, inputs=inputs)[1]
    # each package's f32 logits at the iterations' inputs (rounded to f32)
    # against float64 at the same inputs
    x32 = [x.float() for x in inputs]
    y64 = [tlogits(x.double()).numpy() for x in x32]
    ulps = (max(_ulps(np.asarray(jlogits(jnp.asarray(x.numpy()))), y)
                for x, y in zip(x32, y64)),
            max(_ulps(tlogits32(x).numpy(), y) for x, y in zip(x32, y64)))
    # row 0's adversary in float64, between JAX's f32 1.1162617 and the
    # port's 1.1162477 (test_fab_targeted_matches_jax)
    assert 1.1162477 < base[0, 0] < 1.1162617
    h, u = 1e-8, 2.0 ** -24
    sens, mag_sens = np.zeros(5), 0.0
    mag = (base[0] ** 2 * red).sum()
    for k in range(2):
        for i in range(len(centers)):
            e = [torch.zeros(5, len(centers), dtype=torch.float64)
                 for _ in range(2)]
            e[k][:, i] = h
            d = (port_run(draws[0, 0], la, e)[1][0] - base[0]) / h
            sens += np.abs(d)
            mag_sens += abs((2 * base[0] * red * d).sum())
    np.testing.assert_allclose(sens.max() * u, FAB_SENSITIVITY, rtol=5e-3)
    np.testing.assert_allclose(mag_sens * u / mag, FAB_MAG_SENSITIVITY,
                               rtol=5e-3)
    assert FAB_ATOL <= FAB_SENSITIVITY * sum(ulps), ulps
    assert FAB_MAG_RTOL <= FAB_MAG_SENSITIVITY * sum(ulps), ulps


def test_square_matches_jax(toy):
    jlogits, tlogits, labels, rj, rt = toy
    want = jsq.square_attack(jlogits, jnp.asarray(labels), KEY, rj,
                             n_iter=30, n_restarts=2)
    got = tsq.square_attack(tlogits, torch.tensor(labels), _GEN, rt,
                            n_iter=30, n_restarts=2,
                            draws=square_draws(KEY, rj, 30, 2))
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    want_d = np.asarray(want.deltas)
    edge = np.abs(np.asarray(rj.red_ellipse.sq_dist(want.deltas)) - 1.0) \
        <= 5e-4
    np.testing.assert_allclose(got.deltas.numpy()[~edge], want_d[~edge],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.deltas.numpy()[edge], want_d[edge],
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got.magnitudes.numpy(),
                               np.asarray(want.magnitudes), rtol=5e-4,
                               atol=1e-5)
    assert got.success.any() and edge.any()


def test_square_draws_from_generator(toy):
    """Without injected draws the port draws from its generator: the same
    seed gives the same result, feasible deltas, re-verified successes."""
    _, tlogits, labels, _, rt = toy
    runs = [tsq.square_attack(tlogits, torch.tensor(labels),
                              torch.Generator().manual_seed(5), rt,
                              n_iter=30) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    res = runs[0]
    assert tg.in_ellps(res.deltas, rt.red_ellipse, atol=1e-3)
    preds = tlogits(res.deltas).argmax(1).numpy()
    assert (preds[res.success.numpy()] != 0).all()


# -- the presets ----------------------------------------------------------

PRESET_KW = {"square_queries": 12, "preset_iters": 4}


def preset_draws(key, rj, version, n_target):
    """{attack: the JAX package's draws} for run_standard_evaluation's
    key splits, in the preset's order."""
    apgd_r, fab_r = jaa.VERSION_RESTARTS[version]
    draws = {}
    for name in jaa.VERSION_PRESETS[version]:
        key, sub = jax.random.split(key)
        if name in ("apgd-ce", "apgd-dlr"):
            draws[name] = apgd_draws(sub, rj, apgd_r)
        elif name == "apgd-t":
            draws[name] = targeted_draws(sub, rj, n_target, 1)
        elif name == "fab-t":
            draws[name] = targeted_draws(sub, rj, n_target, fab_r)
        else:
            draws[name] = square_draws(sub, rj, PRESET_KW["square_queries"],
                                       1)
    return draws


@pytest.mark.parametrize("version", ["standard", "rand", "plus"])
def test_run_standard_evaluation_matches_jax(version):
    jlogits, tlogits, labels, rj, rt = _toy(n_gallery=4)
    key = jax.random.PRNGKey(7)
    want = jaa.run_standard_evaluation(jlogits, jnp.asarray(labels), key, rj,
                                       version=version, **PRESET_KW)
    draws = preset_draws(key, rj, version, n_target=3)
    got = taa.run_standard_evaluation(tlogits, torch.tensor(labels), _GEN,
                                      rt, version=version, draws=draws,
                                      **PRESET_KW)
    assert list(got.robust_accuracy.items()) == \
        list(want.robust_accuracy.items())
    assert got.success.any()
    np.testing.assert_allclose(got.deltas.numpy(), np.asarray(want.deltas),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.y_adv.numpy(), np.asarray(want.y_adv))
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    np.testing.assert_allclose(got.magnitudes.numpy(),
                               np.asarray(want.magnitudes), rtol=1e-5,
                               atol=1e-7)


def test_make_standard_evaluation_runs_the_preset(toy):
    """The factory (dists_fn(params, w), the latents threaded in) gives
    the closure path's result from the same generator seed."""
    centers, dirs, lats = _toy_problem()
    _, _, _, _, rt = toy
    gallery, lats, labels = (torch.tensor(centers), torch.tensor(lats),
                             torch.zeros(4, dtype=torch.int64))
    run = taa.make_standard_evaluation(
        lambda params, w: tcdist(w, params["gallery"]), rt, version="rand",
        **PRESET_KW)
    got = run({"gallery": gallery}, lats, labels,
              torch.Generator().manual_seed(4))
    want = taa.run_standard_evaluation(
        lambda d: -tcdist(lats + tg.matmul_f32(d, rt.dirs.t()), gallery),
        labels, torch.Generator().manual_seed(4), rt, version="rand",
        **PRESET_KW)
    assert got.robust_accuracy == want.robust_accuracy
    assert torch.equal(got.deltas, want.deltas)
    with pytest.raises(ValueError, match="unknown AutoAttack version"):
        taa.make_standard_evaluation(None, rt, version="bogus")


def test_run_attack_defaults_and_refusals(toy, monkeypatch):
    _, tlogits, labels, _, rt = toy
    seen = {}

    def fake_apgd(logits_fn, labels, gen, region, *, loss, n_iter,
                  n_restarts):
        seen.update(loss=loss, n_iter=n_iter, n_restarts=n_restarts)
        z = torch.zeros((4, 5))
        return tapgd.APGDResult(z, torch.zeros(4, dtype=torch.bool),
                                torch.zeros(4))

    monkeypatch.setattr(taa, "apgd_attack", fake_apgd)
    y = torch.tensor(labels)
    with pytest.warns(UserWarning, match="apgd-ce.*IGNORED"):
        taa.run_attack(tlogits, y, _GEN, rt, "apgd-ce", iters=5, restarts=3)
    assert seen == {"loss": "ce", "n_iter": 100, "n_restarts": 1}
    taa.run_attack(tlogits, y, _GEN, rt, "apgd-dlr", iters=5, restarts=3,
                   apgd_use_cli_iters=True)
    assert seen == {"loss": "dlr", "n_iter": 5, "n_restarts": 3}
    with pytest.raises(NotImplementedError, match="use fab-t"):
        taa.run_attack(tlogits, y, _GEN, rt, "fab")
    with pytest.raises(ValueError, match="unknown attack"):
        taa.run_attack(tlogits, y, _GEN, rt, "bogus")
    assert taa.VERSION_PRESETS == jaa.VERSION_PRESETS
    assert taa.VERSION_RESTARTS == jaa.VERSION_RESTARTS


def test_find_adversaries_autoattack_matches_jax(toy):
    """The CLI's entry: one attack through dists_fn on the latents, the
    re-verified success and the magnitudes."""
    centers, dirs, _ = _toy_problem()
    _, _, labels, rj, rt = toy
    lats = _latents()
    want = jaa.find_adversaries_autoattack(
        lambda w: jcdist(w, jnp.asarray(centers)), jnp.asarray(lats),
        jnp.asarray(labels), KEY, rj, "apgd-t", iters=6, restarts=1,
        n_target_classes=2)
    got = taa.find_adversaries_autoattack(
        lambda w: tcdist(w, torch.tensor(centers)), torch.tensor(lats),
        torch.tensor(labels), _GEN, rt, "apgd-t", iters=6, restarts=1,
        n_target_classes=2, draws=targeted_draws(KEY, rj, 2, 1))
    _assert_result_equal(got, want)


# -- checks ---------------------------------------------------------------

_rng = np.random.default_rng(3)
X = _rng.standard_normal((8, 16)).astype(np.float32)
Y = _rng.integers(0, 4, 8)
W = _rng.standard_normal((16, 4)).astype(np.float32)


def _both(fn_np):
    """The same model as a JAX and a torch callable."""
    return (lambda x: jnp.asarray(fn_np(np.asarray(x))),
            lambda x: torch.tensor(fn_np(x.numpy())))


@pytest.mark.parametrize("model", ["logits", "softmax", "noisy"])
def test_checks_match_jax(model):
    state = {"i": 0}

    def fn(x):
        out = x @ W
        if model == "softmax":
            e = np.exp(out - out.max(1, keepdims=True))
            return e / e.sum(1, keepdims=True)
        if model == "noisy":
            state["i"] += 1
            return out + 0.1 * np.random.default_rng(state["i"]
                                                     ).standard_normal(
                out.shape).astype(np.float32)
        return out

    jfn, tfn = _both(fn)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state["i"] = 0
        want = jchecks.run_all_checks(jfn, jnp.asarray(X), jnp.asarray(Y))
        state["i"] = 0
        got = tchecks.run_all_checks(tfn, torch.tensor(X), torch.tensor(Y))
    assert got == want
    assert got["prob_output"] == (model == "softmax")
    assert got["randomized"] == (model == "noisy")


def test_zero_gradient_square_sr_and_retracing_checks():
    g = _rng.standard_normal((6, 5)).astype(np.float32)
    g[[2, 4]] = 0.0
    with pytest.warns(Warning, match="zero gradient"):
        assert tchecks.check_zero_gradients(torch.tensor(g)) == \
            jchecks.check_zero_gradients(jnp.asarray(g)) == 2
    for acc in ({"apgd-ce": 0.5, "fab-t": 0.48, "square": 0.49},
                {"apgd-ce": 0.5, "fab-t": 0.48, "square": 0.40},
                {"clean": 1.0, "square": 0.2}):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert tchecks.check_square_sr(acc) == \
                jchecks.check_square_sr(acc)
    assert tchecks.check_retracing(lambda x: x, (torch.zeros(2),)) is False
    assert jchecks.check_retracing(lambda x: x, (jnp.zeros(2),)) is False

    class Log:
        lines = []

        def info(self, msg):
            self.lines.append(msg)

    log = Log()
    tchecks.check_zero_gradients(torch.tensor(g), logger=log)
    assert log.lines and log.lines[0].startswith("Warning: there are 2")
