"""InterFaceGAN boundary tooling (port of certifyingfacerecognition_tpu/
ops/manipulator.py): train a linear attribute boundary, orthogonalise it
against condition boundaries, and sweep a latent along it. Host-side
numpy: boundary training is a one-off offline step, not a device workload.

The JAX package fits its boundary with scikit-learn's ``SVC(kernel=
"linear")``; this port solves the same problem itself (``fit_linear_svm``:
the soft-margin dual with C = 1 and a free intercept, by SMO with
libsvm's second-order working-set selection, in float64, stopped at
libsvm's default KKT tolerance 1e-3).
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

_TAU = 1e-12         # libsvm's floor for a non-positive curvature


def fit_linear_svm(x: np.ndarray, y: np.ndarray, c: float = 1.0,
                   tol: float = 1e-3, max_iter: int = 10_000_000
                   ) -> Tuple[np.ndarray, float]:
    """Soft-margin linear SVM: (w [d], b) with decision(x) = x . w + b,
    positive for the label-1 class. ``y`` holds 0/1 labels.

    Solves min_a 1/2 a^T Q a - sum(a), 0 <= a <= c, y . a = 0 with
    Q_ij = y_i y_j x_i . x_j (labels as -1/+1), two coordinates at a time:
    i the most violating index of the up set, j the index of the low set
    with the largest second-order decrease; stops when the maximal KKT
    violation m(a) - M(a) is below ``tol``. The intercept is libsvm's:
    the mean of -y_i G_i over the free a_i, else the middle of the
    bounds."""
    x = np.asarray(x, np.float64)
    ys = np.where(np.asarray(y) == 1, 1.0, -1.0)
    n = x.shape[0]
    diag = np.einsum("ij,ij->i", x, x)
    alpha = np.zeros(n)
    grad = -np.ones(n)                       # G = Q a - 1

    def q_col(i):
        return ys * ys[i] * (x @ x[i])

    for _ in range(max_iter):
        yg = ys * grad
        up = np.where(ys > 0, alpha < c, alpha > 0)
        low = np.where(ys > 0, alpha > 0, alpha < c)
        cand = np.where(up, -yg, -np.inf)
        i = int(np.argmax(cand))
        g_max = cand[i]
        g_max2 = np.max(np.where(low, yg, -np.inf))
        if g_max + g_max2 < tol:
            break
        k_i = x @ x[i]
        b = g_max + yg
        ok = low & (b > 0)
        if not ok.any():
            break
        a = diag[i] + diag - 2.0 * k_i
        a = np.where(a > 0, a, _TAU)
        obj = np.where(ok, -(b * b) / a, np.inf)
        j = int(np.argmin(obj))

        q_i, q_j = ys * ys[i] * k_i, q_col(j)
        old_i, old_j = alpha[i], alpha[j]
        if ys[i] != ys[j]:
            quad = max(diag[i] + diag[j] + 2.0 * q_i[j], _TAU)
            delta = (-grad[i] - grad[j]) / quad
            diff = alpha[i] - alpha[j]
            alpha[i] += delta
            alpha[j] += delta
            if diff > 0:
                if alpha[j] < 0:
                    alpha[j], alpha[i] = 0.0, diff
            elif alpha[i] < 0:
                alpha[i], alpha[j] = 0.0, -diff
            if diff > 0:                     # c_i - c_j = 0
                if alpha[i] > c:
                    alpha[i], alpha[j] = c, c - diff
            elif alpha[j] > c:
                alpha[j], alpha[i] = c, c + diff
        else:
            quad = max(diag[i] + diag[j] - 2.0 * q_i[j], _TAU)
            delta = (grad[i] - grad[j]) / quad
            total = alpha[i] + alpha[j]
            alpha[i] -= delta
            alpha[j] += delta
            if total > c:
                if alpha[i] > c:
                    alpha[i], alpha[j] = c, total - c
            elif alpha[j] < 0:
                alpha[j], alpha[i] = 0.0, total
            if total > c:
                if alpha[j] > c:
                    alpha[j], alpha[i] = c, total - c
            elif alpha[i] < 0:
                alpha[i], alpha[j] = 0.0, total
        grad += q_i * (alpha[i] - old_i) + q_j * (alpha[j] - old_j)

    yg = ys * grad
    free = (alpha > 0) & (alpha < c)
    if free.any():
        rho = float(yg[free].mean())
    else:
        at_c, at_0 = alpha >= c, alpha <= 0
        ub = np.min(yg[(at_c & (ys < 0)) | (at_0 & (ys > 0))], initial=np.inf)
        lb = np.max(yg[(at_c & (ys > 0)) | (at_0 & (ys < 0))],
                    initial=-np.inf)
        rho = (ub + lb) / 2
    return (alpha * ys) @ x, -rho


def _predict(w: np.ndarray, b: float, x: np.ndarray) -> np.ndarray:
    return (np.asarray(x, np.float64) @ w + b > 0).astype(np.int64)


def train_boundary(latent_codes: np.ndarray, scores: np.ndarray,
                   chosen_num_or_ratio: float = 0.02,
                   split_ratio: float = 0.7,
                   invalid_value: Optional[float] = None,
                   seed: Optional[int] = None,
                   logger: Optional[logging.Logger] = None) -> np.ndarray:
    """Fit a unit-norm linear attribute boundary, shape [1, latent_dim].

    The top/bottom ``chosen_num`` samples by score are the positive and
    negative classes of a linear SVM (``fit_linear_svm``), trained on a
    ``split_ratio`` share of each, shuffled by ``seed``; the validation
    and remaining-set accuracies are logged."""
    log = logger or logging.getLogger("train_boundary")
    lat = np.asarray(latent_codes)
    sc = np.asarray(scores)
    if lat.ndim != 2:
        raise ValueError("latent_codes must be [num_samples, latent_dim]")
    if sc.ndim != 2 or sc.shape != (lat.shape[0], 1):
        raise ValueError("scores must be [num_samples, 1]")
    if chosen_num_or_ratio <= 0:
        raise ValueError("chosen_num_or_ratio must be positive")

    if invalid_value is not None:
        keep = sc[:, 0] != invalid_value
        lat, sc = lat[keep], sc[keep]

    order = np.argsort(sc[:, 0])[::-1]
    lat, sc = lat[order], sc[order]
    n = lat.shape[0]
    chosen = (int(n * chosen_num_or_ratio) if 0 < chosen_num_or_ratio <= 1
              else int(chosen_num_or_ratio))
    chosen = min(chosen, n // 2)
    n_train = int(chosen * split_ratio)
    n_val = chosen - n_train

    rng = np.random.default_rng(seed)
    pos_idx = rng.permutation(chosen)
    neg_idx = rng.permutation(chosen)
    pos, neg = lat[:chosen], lat[-chosen:]
    train_x = np.concatenate([pos[pos_idx[:n_train]],
                              neg[neg_idx[:n_train]]])
    train_y = np.concatenate([np.ones(n_train, np.int64),
                              np.zeros(n_train, np.int64)])
    log.info(f"Training boundary: {n_train} positive, {n_train} negative")

    w, b = fit_linear_svm(train_x, train_y)

    if n_val:
        val_x = np.concatenate([pos[pos_idx[n_train:]],
                                neg[neg_idx[n_train:]]])
        val_y = np.concatenate([np.ones(n_val, np.int64),
                                np.zeros(n_val, np.int64)])
        acc = float((_predict(w, b, val_x) == val_y).mean())
        log.info(f"Validation accuracy: {acc:.6f}")
    rest = lat[chosen:n - chosen]
    if len(rest):
        decision = (sc[0, 0] + sc[-1, 0]) / 2
        rest_y = (sc[chosen:n - chosen, 0] >= decision).astype(np.int64)
        acc = float((_predict(w, b, rest) == rest_y).mean())
        log.info(f"Remaining-set accuracy: {acc:.6f}")

    a = w.reshape(1, lat.shape[1]).astype(np.float32)
    return a / np.linalg.norm(a)


def project_boundary(primal: np.ndarray, *conds: np.ndarray) -> np.ndarray:
    """Orthogonalise ``primal`` against condition boundaries; all inputs
    and the output unit-norm [1, d]. The least-squares coefficients of
    primal in span(conds) come from the normal equations with a 1e-8
    ridge (the reference's stabiliser for near-parallel conditions)."""
    primal = np.asarray(primal, np.float64)
    assert primal.ndim == 2 and primal.shape[0] == 1
    if not conds:
        return primal.astype(np.float32)
    C = np.concatenate([np.asarray(c, np.float64) for c in conds], axis=0)
    assert C.shape[1] == primal.shape[1]
    A = C @ C.T + 1e-8 * np.eye(C.shape[0])
    x = np.linalg.solve(A, C @ primal.T)
    new = primal - x.T @ C
    return (new / np.linalg.norm(new)).astype(np.float32)


def linear_interpolate(latent_code: np.ndarray, boundary: np.ndarray,
                       start_distance: float = -3.0,
                       end_distance: float = 3.0,
                       steps: int = 10) -> np.ndarray:
    """Sweep a latent code along a boundary direction: [1, d] (W/Z) or
    [1, L, d] (W+) in, [steps, ...] out."""
    lat = np.asarray(latent_code, np.float32)
    b = np.asarray(boundary, np.float32)
    assert b.ndim == 2 and b.shape[0] == 1 and b.shape[1] == lat.shape[-1]
    assert lat.shape[0] == 1
    lin = np.linspace(start_distance, end_distance, steps).astype(np.float32)
    if lat.ndim == 2:
        return lat + lin[:, None] * b
    if lat.ndim == 3:
        return lat + lin[:, None, None] * b[None]
    raise ValueError("latent_code must be [1, d] or [1, L, d]")
