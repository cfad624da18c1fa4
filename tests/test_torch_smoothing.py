"""The port's fixed-N certifier (certifyingfacerecognition_torch.smoothing)
against the JAX package's, on the CPU at 32^2 in f32: same weights, same
gallery, and the JAX-drawn noise injected into the port (the two
frameworks draw different random streams). Per-class counts, cAHat,
pABar, the prediction and the gap must be equal exactly, with ragged last
batches in both phases. The stats functions are held to utils/stats.py.

Torch runs one intra-op thread per process: the suite runs in several
pytest-xdist workers that share the machine's cores."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.models import iresnet as jir
from certifyingfacerecognition_tpu.models import pipeline as jpl
from certifyingfacerecognition_tpu.models import stylegan as jsg
from certifyingfacerecognition_tpu.ops import geometry as jgeo
from certifyingfacerecognition_tpu.smoothing import certificate as jcert
from certifyingfacerecognition_tpu.smoothing import smooth as jsm
from certifyingfacerecognition_tpu.utils import stats as jst
from certifyingfacerecognition_tpu.utils import weights as jw
from certifyingfacerecognition_torch.models import pipeline as tpl
from certifyingfacerecognition_torch.ops import geometry as tgeo
from certifyingfacerecognition_torch.smoothing import certificate as tcert
from certifyingfacerecognition_torch.smoothing import smooth as tsm
from certifyingfacerecognition_torch.utils import stats as tst
from certifyingfacerecognition_torch.utils import weights as tw

RES, BS, N0, N, SIGMA = 32, 16, 20, 40, 0.6
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    gen = jsg.random_params(RES, seed=0)
    frm = jir.convert_torch_state_dict(
        jir.random_torch_style_state_dict("iresnet18", seed=0,
                                          realistic=True), "iresnet18")
    dirs = np.asarray(jgeo.get_all_matrices().dirs).T
    ws = np.random.default_rng(0).standard_normal((4, 512)).astype(
        np.float32)
    jpipe = jpl.FacePipeline(gen, frm, dirs=jnp.asarray(dirs),
                             resolution=RES)
    gallery = np.asarray(jpipe.lat2embs(jnp.asarray(ws)))
    jpipe.gallery = jnp.asarray(gallery)
    sigma = np.full((dirs.shape[0],), SIGMA, np.float32)
    fn, params = jpipe.predict_fn_with_params()
    jsmooth = jsm.Smooth(fn, 4, sigma, jcert.L2Certificate(),
                         noise_dim=dirs.shape[0], batch_size=BS,
                         params=params)

    tpipe = tpl.FacePipeline(
        tw.params_from_jax(jw.flatten_params(gen), device="cpu"),
        tw.params_from_jax(jw.flatten_params(frm), device="cpu"),
        dirs=torch.tensor(dirs), resolution=RES,
        gallery=torch.tensor(gallery), device="cpu")
    fn, params = tpipe.predict_fn_with_params()
    tsmooth = tsm.Smooth(fn, 4, sigma, tcert.L2Certificate(),
                         noise_dim=dirs.shape[0], batch_size=BS,
                         params=params, device="cpu")
    return jsmooth, tsmooth, ws, sigma


def _jax_noise(key, num, dim, sigma):
    """The noise jax Smooth._sample_noise draws for ``num`` samples."""
    n_batches = -(-num // BS)
    return np.stack([np.asarray(jcert.L2Certificate().sample_noise(
        k, (BS, dim), jnp.asarray(sigma))) for k in jax.random.split(
            key, n_batches)])


def _recording(smooth):
    """Record the counts vector of every _sample_noise call."""
    calls, orig = [], smooth._sample_noise

    def rec(*args, **kwargs):
        calls.append(orig(*args, **kwargs))
        return calls[-1]

    smooth._sample_noise = rec
    return calls


def _certify_both(both, idents, n0, n):
    """Certify each identity in both packages with the JAX noise; the
    outcomes must be equal, and so must the counts of every
    _sample_noise call. Returns (outcomes, counts per call)."""
    jsmooth, tsmooth, ws, sigma = both
    x = np.zeros(sigma.shape, np.float32)
    jcalls, tcalls = _recording(jsmooth), _recording(tsmooth)
    outcomes = []
    try:
        for ident in idents:
            key = jax.random.fold_in(jax.random.PRNGKey(0), ident)
            k0, k1 = jax.random.split(key)
            pj, gj = jsmooth.certify(ws[ident], x, ident, n0, n, 0.001, key)
            pt, gt = tsmooth.certify(
                ws[ident], x, ident, n0, n, 0.001, torch.Generator(),
                noise0=_jax_noise(k0, n0, sigma.size, sigma),
                noise=_jax_noise(k1, n, sigma.size, sigma))
            assert (pt, gt) == (pj, gj)
            outcomes.append(pt)
    finally:
        del jsmooth._sample_noise, tsmooth._sample_noise
    # selection counts and (for selected identities) estimation counts
    assert len(tcalls) == len(jcalls)
    for ct, cj in zip(tcalls, jcalls):
        np.testing.assert_array_equal(ct, cj)
        assert ct.sum() in (n0, n)
    c_a = int(tcalls[1].argmax())
    assert tst.clopper_pearson_lower(tcalls[1][c_a], n, 0.001) == \
        jst.clopper_pearson_lower(jcalls[1][c_a], n, 0.001)
    return outcomes, tcalls


@pytest.mark.slow
def test_certify_with_injected_jax_noise_matches_jax(both):
    outcomes, calls = _certify_both(both, range(2), N0, N)
    assert len(calls) >= 3
    assert 0 in outcomes, outcomes     # identity 0 certifies at this sigma


def test_certify_one_identity_with_injected_jax_noise_matches_jax(both):
    """The small case of the test above: identity 0, one ragged selection
    batch (10 of 16) and two estimation batches, the last ragged."""
    outcomes, calls = _certify_both(both, [0], 10, 20)
    assert len(calls) == 2
    assert outcomes == [0], outcomes   # identity 0 certifies at this sigma


def test_predict_with_injected_noise_matches_jax(both):
    jsmooth, tsmooth, ws, sigma = both
    x = np.zeros(sigma.shape, np.float32)
    key = jax.random.PRNGKey(3)
    noise = _jax_noise(key, N, sigma.size, sigma)
    assert tsmooth.predict(ws[0], x, N, 0.001, torch.Generator(),
                           noise=noise) == \
        jsmooth.predict(ws[0], x, N, 0.001, key)


def test_generator_noise_counts_cover_exact_sample_count(both):
    _, tsmooth, ws, sigma = both
    gen = tsm.identity_generator(0, 1, "cpu")
    counts = tsmooth._sample_noise(ws[1], np.zeros(sigma.shape), 37, gen)
    assert counts.sum() == 37
    g1 = tsm.identity_generator(0, 1, "cpu")
    g2 = tsm.identity_generator(0, 2, "cpu")
    assert torch.equal(torch.randn(4, generator=tsm.identity_generator(
        0, 1, "cpu")), torch.randn(4, generator=g1))
    assert not torch.equal(torch.randn(4, generator=g1),
                           torch.randn(4, generator=g2))


def test_anisotropic_noise_scales_each_axis():
    sigma = np.array([0.1, 1.0, 3.0], np.float32)
    noise = tcert.L2Certificate().sample_noise(
        torch.Generator().manual_seed(0), (20_000, 3), sigma)
    np.testing.assert_allclose(noise.std(0).numpy(), sigma, rtol=0.05)


@pytest.mark.parametrize("k,n", [(0, 10), (7, 10), (10, 10), (990, 1000),
                                 (500, 1000)])
def test_stats_match_jax(k, n):
    assert tst.clopper_pearson_lower(k, n, 0.001) == \
        jst.clopper_pearson_lower(k, n, 0.001)
    assert tst.clopper_pearson_upper(k, n, 0.01) == \
        jst.clopper_pearson_upper(k, n, 0.01)
    assert tst.binom_two_sided_pvalue(k, n) == jst.binom_two_sided_pvalue(k, n)
    p = (k + 0.5) / (n + 1)
    assert tst.gaussian_quantile(p) == jst.gaussian_quantile(p)
    assert tcert.L2Certificate().compute_gap(p) == \
        jcert.L2Certificate().compute_gap(p)


def test_geometry_matches_jax():
    rt, rj = tgeo.get_all_matrices(), jgeo.get_all_matrices()
    for name in ("proj_mat", "dirs", "dirs_inv", "red_ellipse_diag",
                 "red_ellipse_diag_inv"):
        np.testing.assert_array_equal(getattr(rt, name),
                                      np.asarray(getattr(rj, name)))
    np.testing.assert_allclose(rt.ellipse_mat, np.asarray(rj.ellipse.mat()),
                               rtol=1e-4, atol=1e-5)
