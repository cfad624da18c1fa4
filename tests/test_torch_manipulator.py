"""The port's boundary tooling against the JAX package's:
project_boundary and linear_interpolate to 1e-6; train_boundary, whose
linear SVM the port solves itself (SMO) where the JAX package calls
scikit-learn's SVC, to a cosine >= 0.999 with JAX's boundary on a
separable set of a few hundred points, with the same validation and
remaining-set accuracies (the same predictions counted) and the same
input errors."""

import logging

import numpy as np
import pytest

from certifyingfacerecognition_tpu.ops import manipulator as jm
from certifyingfacerecognition_torch.ops import manipulator as tm


def _attribute_data(n, d, noise, seed):
    """Latents whose attribute score is a noisy linear function."""
    rng = np.random.default_rng(seed)
    true_dir = rng.standard_normal(d)
    true_dir /= np.linalg.norm(true_dir)
    lat = rng.standard_normal((n, d)).astype(np.float32)
    scores = (lat @ true_dir + noise * rng.standard_normal(n)).astype(
        np.float32)[:, None]
    return lat, scores


def _accuracy_lines(caplog, fn, *args, **kwargs):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="train_boundary"):
        boundary = fn(*args, **kwargs)
    return boundary, [r.getMessage() for r in caplog.records
                      if "accuracy" in r.getMessage()]


@pytest.mark.parametrize("n,d,noise,ratio", [(400, 32, 0.05, 0.25),
                                             (300, 64, 0.3, 0.4)],
                         ids=["separable-d32", "noisy-d64"])
def test_train_boundary_matches_jax(caplog, n, d, noise, ratio):
    lat, scores = _attribute_data(n, d, noise, seed=7)
    want, want_acc = _accuracy_lines(caplog, jm.train_boundary, lat, scores,
                                     chosen_num_or_ratio=ratio, seed=0)
    got, got_acc = _accuracy_lines(caplog, tm.train_boundary, lat, scores,
                                   chosen_num_or_ratio=ratio, seed=0)
    assert got.shape == want.shape == (1, d) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got), 1.0, rtol=1e-5)
    assert float(got[0] @ want[0]) >= 0.999
    assert len(got_acc) == 2 and got_acc == want_acc


def test_fit_linear_svm_matches_sklearn_decisions():
    """The solver alone, on an overlapping set: the same training-set
    predictions as scikit-learn's SVC(kernel="linear") and its boundary."""
    from sklearn import svm

    lat, scores = _attribute_data(200, 16, 1.0, seed=3)
    y = (scores[:, 0] > np.median(scores)).astype(np.int64)
    w, b = tm.fit_linear_svm(lat, y)
    clf = svm.SVC(kernel="linear").fit(lat, y)
    coef = clf.coef_[0]
    assert w @ coef / np.linalg.norm(w) / np.linalg.norm(coef) >= 0.999
    assert abs(b - clf.intercept_[0]) < 0.05
    agree = (tm._predict(w, b, lat) == clf.predict(lat)).mean()
    assert agree >= 0.99


@pytest.mark.parametrize("bad", ["latent-1d", "scores-1d", "ratio-0"])
def test_train_boundary_raises_as_jax(bad):
    lat, scores = _attribute_data(50, 8, 0.05, seed=1)
    args, kw = {"latent-1d": ((lat[0], scores), {}),
                "scores-1d": ((lat, scores[:, 0]), {}),
                "ratio-0": ((lat, scores), {"chosen_num_or_ratio": 0.0})}[bad]
    with pytest.raises(ValueError) as want:
        jm.train_boundary(*args, seed=0, **kw)
    with pytest.raises(ValueError) as got:
        tm.train_boundary(*args, seed=0, **kw)
    assert str(got.value) == str(want.value)


def test_project_boundary_matches_jax():
    rng = np.random.default_rng(11)
    d = 64
    primal = rng.standard_normal((1, d))
    primal /= np.linalg.norm(primal)
    conds = [c / np.linalg.norm(c) for c in rng.standard_normal((3, 1, d))]
    for k in range(4):
        got = tm.project_boundary(primal, *conds[:k])
        np.testing.assert_allclose(got, jm.project_boundary(primal,
                                                            *conds[:k]),
                                   atol=1e-6)
        assert got.dtype == np.float32


def test_linear_interpolate_matches_jax():
    rng = np.random.default_rng(12)
    d = 24
    b = rng.standard_normal((1, d)).astype(np.float32)
    b /= np.linalg.norm(b)
    for lat in (rng.standard_normal((1, d)).astype(np.float32),
                rng.standard_normal((1, 14, d)).astype(np.float32)):
        got = tm.linear_interpolate(lat, b, -2.0, 2.0, 7)
        np.testing.assert_allclose(
            got, jm.linear_interpolate(lat, b, -2.0, 2.0, 7), atol=1e-6)
    with pytest.raises(ValueError):
        tm.linear_interpolate(np.zeros((1, 2, 3, d), np.float32), b)
