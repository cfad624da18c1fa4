"""The reference pipeline and its decisions: latent -> image -> resize ->
face-recognition embedding, gallery distances in float64, the
Clopper-Pearson certificate and the attribute ellipsoid."""

from __future__ import annotations

import math
from pathlib import Path
from statistics import NormalDist

import numpy as np
import torch
import torch.nn.functional as F

from .precision import F32, Precision

ATTRS = (("age", 0.5), ("eyeglasses", 0.5), ("gender", 0.2), ("pose", 0.5),
         ("smile", 0.8))


def widths(gen, frm, resolution: int) -> dict:
    """The widths the reference builds at ``resolution`` with the generator
    and FRM family files ``gen`` and ``frm`` (``cfr_bench/families.py``),
    under the keys of a configuration's file."""
    return {**gen.widths(resolution), **frm.widths()}


def check_widths(config: dict, gen, frm) -> None:
    """Refuse a configuration whose file states a width other than the
    one that the reference, and the weights made for the program, have,
    or a gallery head (``frs``) that its FRM does not serve."""
    want = widths(gen, frm, config["resolution"])
    bad = {k: (config.get(k), v) for k, v in want.items()
           if config.get(k) != v}
    if config.get("frs") not in frm.FRS:
        bad["frs"] = (config.get("frs"), frm.FRS)
    if bad:
        raise ValueError(f"{config.get('name')}: (stated, built) {bad}")


def embed(gen, gen_sd, frm, frm_sd, w: torch.Tensor, resolution: int,
          prec: Precision = F32, rows: int = 8) -> torch.Tensor:
    """Embeddings [B, D] of latents [B, L] through the generator family
    ``gen`` and the FRM family ``frm``, ``rows`` at a time (the 1024^2
    float32 activations of a few rows fill a card)."""
    outs = []
    size = frm.INPUT
    for s in range(0, w.shape[0], rows):
        img = prec.q(gen.synthesize(gen_sd, w[s:s + rows], resolution, prec))
        x = prec.q(F.interpolate(img, size=(size, size), mode="bilinear",
                                 align_corners=False))
        outs.append(frm.embed(frm_sd, (x - 0.5) / 0.5, prec))
    return torch.cat(outs)


def distances(frs: str, e: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """[B, N] float64 distances: Euclidean for ArcFace, 1 - cosine for
    FaceNet (whose embeddings are unit vectors)."""
    e, g = e.double(), g.double()
    if frs == "insightface":
        d2 = (e * e).sum(1, keepdim=True) + (g * g).sum(1)[None] \
            - 2.0 * e @ g.t()
        return d2.clamp(min=0.0).sqrt()
    return 1.0 - e @ g.t()


def nearest(frs: str, e: torch.Tensor, g: torch.Tensor,
            prec: Precision = F32) -> torch.Tensor:
    """The gallery head: the nearest row to each embedding, the products
    e . g taken in ``prec`` and the rest in float64."""
    dot = prec.linear(e.float(), g.float()).double()
    if frs == "insightface":
        d = (e.double() ** 2).sum(1, keepdim=True) \
            + (g.double() ** 2).sum(1)[None] - 2.0 * dot
    else:
        d = 1.0 - dot
    return d.argmin(1)


def head_rounding(frs: str, e: torch.Tensor, g: torch.Tensor,
                  d_a: torch.Tensor, d_b: torch.Tensor) -> torch.Tensor:
    """How far a float32 head's rounding alone can rank a row at float64
    distance ``d_a`` before one at ``d_b`` (per embedding of ``e``), from
    the worst-case error of an n-term float32 sum, gamma_n = n u / (1 -
    n u), u = 2^-24, n the embedding's width.

    Euclidean (ArcFace): the k nearest by ||e||^2 + ||g||^2 - 2 e . g,
    each within gamma_{n+2} (||e|| + max ||g||)^2, re-ranked by
    sum (e_i - g_i)^2, each within (gamma_n + 3u) of itself; so d_a^2 -
    d_b^2 is at most the larger of twice each. Cosine (FaceNet): 1 - e . g,
    each within gamma_n ||e|| max ||g|| + u (1 + ||e|| max ||g||)."""
    u = 2.0 ** -24
    n = e.shape[1]

    def gamma(k):
        return k * u / (1.0 - k * u)
    ne = e.double().norm(dim=1)
    ng = float(g.double().norm(dim=1).max())
    if frs == "insightface":
        sq = torch.maximum(2.0 * (gamma(n) + 3 * u) * d_a ** 2,
                           2.0 * gamma(n + 2) * (ne + ng) ** 2)
        return sq / (d_a + d_b).clamp(min=1e-300)
    return 2.0 * (gamma(n) * ne * ng + u * (1.0 + ne * ng))


def directions(boundaries_dir, files) -> np.ndarray:
    """The five attribute directions [5, L] (float64) from a generator
    family's boundary ``files`` (``BOUNDARIES``) under ``boundaries_dir``."""
    return np.concatenate([np.load(Path(boundaries_dir) / f) for f in files],
                          axis=0)


def _mvee(points: np.ndarray, tol: float = 1e-3) -> np.ndarray:
    """Khachiyan's minimum-volume enclosing ellipsoid of the rows of
    ``points``, centred at the origin here: the matrix A of x^T A x = 1."""
    n, d = points.shape
    q = np.column_stack((points, np.ones(n))).T
    u = np.ones(n) / n
    err = tol + 1.0
    while err > tol:
        x = (q * u) @ q.T
        m = np.einsum("ij,ji->i", q.T, np.linalg.solve(x, q))
        j = int(np.argmax(m))
        step = (m[j] - d - 1.0) / ((d + 1) * (m[j] - 1.0))
        new_u = (1 - step) * u
        new_u[j] += step
        err = np.linalg.norm(new_u - u)
        u = new_u
    c = u @ points
    return np.linalg.inv((points.T * u) @ points - np.outer(c, c)) / d


def attribute_ellipse_diag() -> np.ndarray:
    """Diagonal of the attack's feasible ellipsoid in attribute space: the
    minimum-volume ellipsoid around +-(budget_i e_i), as the reference
    method builds it (Khachiyan, tolerance 1e-3)."""
    pts = np.diag([m for _, m in ATTRS])
    a = _mvee(np.concatenate((pts, -pts), axis=1).T)
    return np.diagonal(a).copy()


def _log_binom_tail(k: int, n: int, p: float, log_fact: np.ndarray
                    ) -> float:
    """log P(X >= k) for X ~ Binomial(n, p), 0 < p < 1; ``log_fact[i]``
    is log(i!)."""
    i = np.arange(k, n + 1)
    terms = (log_fact[n] - log_fact[i] - log_fact[n - i]
             + i * math.log(p) + (n - i) * math.log1p(-p))
    top = terms.max()
    return float(top + math.log(np.exp(terms - top).sum()))


def clopper_pearson_lower(k: int, n: int, alpha: float) -> float:
    """The one-sided (1 - alpha) lower bound on p from k of n: the p at
    which P(X >= k) = alpha, by bisection (k = n in closed form)."""
    if k == 0:
        return 0.0
    if k == n:
        return alpha ** (1.0 / n)
    log_fact = np.concatenate(([0.0], np.cumsum(np.log(np.arange(1, n + 1)))))
    lo, hi, target = 0.0, 1.0, math.log(alpha)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if mid <= lo or mid >= hi:
            break
        if _log_binom_tail(k, n, mid, log_fact) < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def certificate(preds0: np.ndarray, preds: np.ndarray, label: int,
                alpha: float):
    """(prediction, gap) of randomized smoothing (Cohen et al.'s CERTIFY)
    from the base classifier's answers of the selection and estimation
    passes; prediction -1 is an abstention."""
    counts0 = np.bincount(preds0)
    c_hat = int(np.argmax(counts0))
    if c_hat != label:
        return c_hat, 0.0
    n_a = int((preds == c_hat).sum())
    p_a = clopper_pearson_lower(n_a, len(preds), alpha)
    if p_a < 0.5:
        return -1, 0.0
    return c_hat, NormalDist().inv_cdf(p_a)
