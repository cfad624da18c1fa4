"""The port's adaptive certification (smoothing/adaptive_device.py and
Smooth.certify_adaptive*) against the JAX package's, on the CPU.

* build_thresholds: the port's tables equal the JAX package's entry for
  entry (t_emit, t_abst, m_k, the alpha split and the exact flag) on a
  grid of modes, budgets with ragged last batches, chunk sizes (one
  checkpoint included), gap targets and slacks; so do the loop shapes.
* On the toy threshold predictor of tests/test_adaptive_device.py
  (class 1 iff p[0] > tau), with the JAX-drawn noise injected into the
  port: the port's host and device engines return the same
  (prediction, gap, n_used) as the JAX package's host and device engines,
  exactly, across clear certifications, borderline ones, abstentions,
  selection failures and gap targets (in guaranteed mode with a gap
  target the device engine is held to JAX's device engine, the one case
  where the two engines may differ).
* Grouped equals single per identity, and pad_to changes nothing.
* Without injected noise, guaranteed mode at slack 0 equals the port's own
  fixed-N certify for the same generator seed.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.smoothing import adaptive_device as jad
from certifyingfacerecognition_tpu.smoothing import certificate as jcert
from certifyingfacerecognition_tpu.smoothing import smooth as jsm
from certifyingfacerecognition_torch.smoothing import adaptive_device as tad
from certifyingfacerecognition_torch.smoothing import certificate as tcert
from certifyingfacerecognition_torch.smoothing import smooth as tsm

torch.set_num_threads(1)
N0, ALPHA, DIM = 100, 0.001, 5


@pytest.mark.parametrize("chunk", [1, 2, 3, "single"])
@pytest.mark.parametrize("n", [1000, 2000, 5000])
@pytest.mark.parametrize("mode", ["guaranteed", "sequential"])
def test_thresholds_equal_jax(mode, n, chunk):
    """Batch 128: every budget ends in a ragged batch (104, 80, 8)."""
    bs = 128
    chunk = -(-n // bs) if chunk == "single" else chunk
    shapes_t = tad._loop_shapes(types.SimpleNamespace(batch_size=bs), N0, n,
                                chunk)
    shapes_j = jad._loop_shapes(types.SimpleNamespace(batch_size=bs), N0, n,
                                chunk)
    assert shapes_t[:4] == shapes_j[:4]
    for got, want in zip(shapes_t[4:], shapes_j[4:]):
        np.testing.assert_array_equal(got, np.asarray(want))
    valid = shapes_t[5]
    for gap_target in (None, 1.0):
        for slack in (0.0, 0.1):
            got = tad.build_thresholds(mode, n, valid, chunk, ALPHA,
                                       tcert.L2Certificate(), slack,
                                       gap_target)
            want = jad.build_thresholds(mode, n, valid, chunk, ALPHA,
                                        jcert.L2Certificate(), slack,
                                        gap_target)
            for field in ("t_emit", "t_abst", "m_k"):
                np.testing.assert_array_equal(getattr(got, field),
                                              getattr(want, field))
            assert (got.alpha_early, got.alpha_final, got.exact) == \
                (want.alpha_early, want.alpha_final, want.exact)


def test_gap_vec_equals_scalar_gap():
    p = np.array([1e-300, 0.3, 0.5, 0.9, 0.999999])
    cert = tcert.L2Certificate()
    np.testing.assert_array_equal(
        tad._gap_vec(cert, p), [cert.compute_gap(float(v)) for v in p])
    np.testing.assert_array_equal(cert.compute_gap_vec(p),
                                  jcert.L2Certificate().compute_gap_vec(p))


@functools.lru_cache(maxsize=None)
def _jax_smooth(tau, bs):
    """Shared by the cases of one (tau, bs): its compiled programs are."""
    return jsm.Smooth(lambda z, p: (p[:, 0] > tau).astype(jnp.int32), 2,
                      1.0, jcert.L2Certificate(), noise_dim=DIM,
                      batch_size=bs)


def _port_smooth(tau, bs):
    return tsm.Smooth(lambda z, p: (p[:, 0] > tau).long(), 2, 1.0,
                      tcert.L2Certificate(), noise_dim=DIM, batch_size=bs,
                      device="cpu")


def _jax_noise(key, num, bs):
    """The noise JAX Smooth._sample_noise draws for ``num`` samples (sigma
    1)."""
    keys = jax.random.split(key, -(-num // bs))
    return np.stack([np.asarray(jcert.L2Certificate().sample_noise(
        k, (bs, DIM), jnp.float32(1.0))) for k in keys])


def _key_noise(key, n, bs):
    """(noise0, noise): the JAX noise of both phases of the identity with
    this key."""
    k0, k1 = jax.random.split(key)
    return _jax_noise(k0, N0, bs), _jax_noise(k1, n, bs)


@functools.lru_cache(maxsize=None)
def _port_noise(seed, n, bs):
    return _key_noise(jax.random.PRNGKey(seed), n, bs)


# (tau, n, chunk, batch, mode, gap_target, seed): the JAX package's test
# configurations (p(class 0) = .9987, .55, .84, .16) and its gap targets
CASES = [(3.0, 10_000, 2, 200, "sequential", None, 0),
         (3.0, 10_000, 2, 200, "guaranteed", None, 1),
         (0.126, 2000, 4, 200, "sequential", None, 0),
         (0.126, 2000, 4, 200, "guaranteed", None, 2),
         (1.0, 5000, 1, 200, "sequential", None, 1),
         (1.0, 5000, 1, 200, "guaranteed", None, 0),
         (-1.0, 1000, 2, 200, "sequential", None, 1),
         (-1.0, 1000, 2, 200, "guaranteed", None, 0),
         (0.126, 1000, 3, 64, "sequential", None, 2),
         (0.126, 1000, 3, 64, "guaranteed", None, 1),
         (3.0, 10_000, 2, 200, "sequential", 1.0, 0),
         (3.0, 10_000, 2, 200, "guaranteed", 1.0, 0)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_engines_match_jax_with_jax_noise(case):
    tau, n, chunk, bs, mode, gap_target, seed = case
    jsmooth, tsmooth = _jax_smooth(tau, bs), _port_smooth(tau, bs)
    key = jax.random.PRNGKey(seed)
    z, x = jnp.zeros(4), np.zeros(DIM)
    noise0, noise = _port_noise(seed, n, bs)
    out = {}
    for engine in ("host", "device"):
        kw = dict(mode=mode, chunk_batches=chunk, gap_target=gap_target,
                  engine=engine)
        out["jax", engine] = jsmooth.certify_adaptive(
            z, x, 0, N0, n, ALPHA, key, **kw)
        out["torch", engine] = tsmooth.certify_adaptive(
            np.zeros(4), x, 0, N0, n, ALPHA, torch.Generator(),
            noise0=noise0, noise=noise, **kw)
    for engine in ("host", "device"):
        assert out["torch", engine] == out["jax", engine], (engine, out)
    if not (mode == "guaranteed" and gap_target is not None):
        assert out["torch", "host"] == out["torch", "device"]


def test_engine_cases_span_every_outcome():
    """The CASES above certify, abstain and fail selection (with the JAX
    noise), and some stop early."""
    outcomes = set()
    for tau, n, chunk, bs, mode, gap_target, seed in CASES:
        noise0, noise = _port_noise(seed, n, bs)
        pred, gap, used = _port_smooth(tau, bs).certify_adaptive(
            np.zeros(4), np.zeros(DIM), 0, N0, n, ALPHA, torch.Generator(),
            mode=mode, chunk_batches=chunk, gap_target=gap_target,
            noise0=noise0, noise=noise)
        outcomes.add({0: "certify", -1: "abstain", 1: "selection"}[pred])
        if used < N0 + n:
            outcomes.add("early")
    assert outcomes == {"certify", "abstain", "selection", "early"}


# One group mixing the regimes through per-identity attribute offsets
# (class 1 iff p[0] > 0): clear certify of label 1, borderline of label 1,
# clear certify of label 0, selection failure of label 0.
OFFSETS, LABELS = [3.0, 0.126, -3.0, 3.0], [1, 1, 0, 0]


def _group(seed_base):
    xs = [np.array([o, 0, 0, 0, 0], np.float32) for o in OFFSETS]
    gens = [torch.Generator().manual_seed(seed_base + i) for i in range(4)]
    return [np.zeros(4)] * 4, xs, gens


@pytest.mark.parametrize("mode", ["sequential", "guaranteed"])
def test_grouped_equals_single_and_pad_to_is_invisible(mode):
    sm = _port_smooth(0.0, 100)
    kw = dict(mode=mode, chunk_batches=2)
    zs, xs, gens = _group(40)
    singles = [sm.certify_adaptive(zs[i], xs[i], LABELS[i], N0, 2000, ALPHA,
                                   gens[i], engine="device", **kw)
               for i in range(4)]
    for pad_to in (0, 8):
        zs, xs, gens = _group(40)
        assert sm.certify_adaptive_many(zs, xs, LABELS, N0, 2000, ALPHA,
                                        gens, pad_to=pad_to, **kw) == singles
    assert singles[0][1] > 0 and singles[3][:2] == (1, 0.0)


@pytest.mark.parametrize("mode", ["sequential", "guaranteed"])
def test_grouped_matches_jax_grouped_with_jax_noise(mode):
    """The group above in both packages, each identity with the noise of
    its fold_in key."""
    sm = _port_smooth(0.0, 100)
    master = jax.random.PRNGKey(42)
    keys = [jax.random.fold_in(master, i) for i in range(4)]
    xs = [np.array([o, 0, 0, 0, 0], np.float32) for o in OFFSETS]
    want = _jax_smooth(0.0, 100).certify_adaptive_many(
        [jnp.zeros(4)] * 4, xs, LABELS, N0, 2000, ALPHA, keys, mode=mode,
        chunk_batches=2)
    noises = [_key_noise(k, 2000, 100) for k in keys]
    got = sm.certify_adaptive_many(
        [np.zeros(4)] * 4, xs, LABELS, N0, 2000, ALPHA,
        [torch.Generator()] * 4, mode=mode, chunk_batches=2,
        noise0=[nz[0] for nz in noises], noise=[nz[1] for nz in noises])
    assert got == want


@pytest.mark.parametrize("tau,n", [(3.0, 2000), (1.0, 1000), (0.126, 1000),
                                   (0.0, 600), (-1.0, 500)])
def test_guaranteed_slack0_equals_fixed_n_certify(tau, n):
    """The noise discipline: both draw the N0 batches, then the N batches
    in order, from the identity's generator; at slack 0 guaranteed mode
    stops early only to abstain, so decisions and gaps are the fixed-N
    run's (over seeds that certify, abstain and fail selection)."""
    sm = _port_smooth(tau, 64)
    for seed in range(3):
        fixed = sm.certify(np.zeros(4), np.zeros(DIM), 0, N0, n, ALPHA,
                           torch.Generator().manual_seed(seed))
        for engine in ("host", "device"):
            pred, gap, used = sm.certify_adaptive(
                np.zeros(4), np.zeros(DIM), 0, N0, n, ALPHA,
                torch.Generator().manual_seed(seed), mode="guaranteed",
                chunk_batches=1, slack=0.0, engine=engine)
            assert (pred, gap) == fixed, (tau, seed, engine)
            if pred == 0:
                assert used == N0 + n
