"""FAB attack (targeted) under the Sigma-ellipsoid norm (port of
certifyingfacerecognition_tpu/attacks/fab.py).

The attack works in the reduced attribute space (deltas [B, k]) on a
classifier logits(deltas) = -distances(lat + deltas @ dirs^T), with the
JAX package's Lsigma2 semantics: a random restart on the ellipsoid
surface, the closed-form Lagrangian projection onto the linearised
decision hyperplane in the Sigma norm (applied to the current and the
original point), extrapolation eta = 1.05, interpolation alpha_max = 0.1,
the backward step beta = 0.9 and the best adversary tracked in the
Sigma-norm, over the 2nd..(T+1)-th nearest classes x restarts. The
projection returns the projected point, which the update uses as a
displacement: the reference's quirk, kept (FAB-t's magnitudes may exceed
the budget; they are reported, not clipped).

The iterations are a Python loop over tensors on the device; the
per-target gradient of diffy is one autograd.grad of the batch sum.

Spans (utils/profiling.span): ``attack.step`` over each iteration with
its best-adversary update, and inside it ``attack.backward`` (the
gradient), ``attack.project`` (the two projections and their norms) and
``attack.update`` (the blend, and the best-adversary update).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops import geometry as G
from ..utils.profiling import span


class FABResult(NamedTuple):
    deltas: torch.Tensor      # [B, k] minimum-Sigma-norm adversarial deltas
    success: torch.Tensor     # [B] bool
    magnitudes: torch.Tensor  # [B] squared Sigma-norms


def _projection_lsigma2(t, w, b, mat_inv_diag):
    """Closed-form projection of t onto {x: w.x + b = 0} in the Sigma
    norm."""
    dist = (w * t).sum(1) + b
    lambd = dist / (G.sq_distance_diag(mat_inv_diag, w) + 1e-12)
    return t - w * mat_inv_diag[None, :] * lambd[:, None]


def _sigma_norm(mat_diag, v):
    return torch.sqrt(torch.clamp(G.sq_distance_diag(mat_diag, v), min=0.0))


def _fab_iteration(logits_fn, x1, x0, labels, la_target, mat, mat_inv, *,
                   alpha_max: float, eta: float, beta: float):
    """One FAB iteration from the iterate x1 [B, k]: (the candidate, whether
    it is adversarial, the next iterate). The candidate blends the
    projections of x1 and x0 onto the hyperplane that linearises
    diffy = logit(target) - logit(label) at x1; the next iterate steps
    back toward x0 by ``beta`` wherever the candidate is adversarial. Any
    float dtype (the tests run it in float64)."""
    rows = torch.arange(x1.shape[0], device=x1.device)
    x = x1.detach().requires_grad_(True)
    with torch.enable_grad():
        y = logits_fn(x)
        diffy = -(y[rows, labels] - y[rows, la_target])
        with span("attack.backward", exclusive=True):
            (dg,) = torch.autograd.grad(diffy.sum(), x)
    with span("attack.project"):
        b = -diffy.detach() + G.sq_distance_diag(mat, dg, x1)
        d1 = _projection_lsigma2(x1, dg, b, mat_inv)
        d2 = _projection_lsigma2(x0, dg, b, mat_inv)
        a1 = torch.clamp(_sigma_norm(mat, d1), min=1e-8)
        a2 = torch.clamp(_sigma_norm(mat, d2), min=1e-8)
    with span("attack.update"):
        alpha = torch.clamp(a1 / (a1 + a2), 0.0, alpha_max)[:, None]
        cand = (x1 + eta * d1) * (1.0 - alpha) + (x0 + eta * d2) * alpha
        cand = torch.where(torch.isnan(cand.sum(1))[:, None], x1, cand)
    is_adv = logits_fn(cand).argmax(dim=1) != labels
    # backward step toward the original point wherever adversarial
    return cand, is_adv, torch.where(is_adv[:, None],
                                     x0 + (cand - x0) * beta, cand)


@torch.no_grad()
def fab_targeted(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    labels: torch.Tensor,            # [B]
    gen: torch.Generator,
    region: G.RegionMatrices,
    *,
    n_iter: int = 5,
    n_restarts: int = 2,
    n_target_classes: int = 2,
    alpha_max: float = 0.1,
    eta: float = 1.05,
    beta: float = 0.9,
    init: Optional[torch.Tensor] = None,
) -> FABResult:
    """Targeted FAB from zero deltas. Returns min-norm deltas (zeros where
    no adversary was found). ``init`` [n_target_classes, n_restarts, B, k],
    when given, replaces the random initial deltas of each run."""
    B = labels.shape[0]
    k = region.dirs.shape[1]
    mat = region.red_ellipse_diag
    mat_inv = region.red_ellipse_diag_inv
    x0 = torch.zeros((B, k), dtype=mat.dtype, device=labels.device)
    logits0 = logits_fn(x0)
    pred_mask = logits0.argmax(dim=1) == labels     # attack correct points
    # stable, as jnp.argsort: ties keep the JAX package's target order
    order = torch.argsort(logits0, dim=1, stable=True)

    def single_run(deltas0, la_target):
        x1 = x0 + deltas0
        adv = x0
        res2 = torch.full((B,), 1e10, dtype=x0.dtype, device=x0.device)
        for _ in range(n_iter):
            with span("attack.step", outer=True):
                cand, is_adv, x1 = _fab_iteration(
                    logits_fn, x1, x0, labels, la_target, mat, mat_inv,
                    alpha_max=alpha_max, eta=eta, beta=beta)
                with span("attack.update"):
                    t = _sigma_norm(mat, cand - x0)
                    better = is_adv & (t < res2)
                    adv = torch.where(better[:, None], cand, adv)
                    res2 = torch.where(better, t, res2)
        return adv, res2

    best = x0
    best_res = torch.full((B,), float("inf"), dtype=x0.dtype,
                          device=x0.device)
    success = torch.zeros((B,), dtype=torch.bool, device=x0.device)
    for t, target_class in enumerate(range(2, n_target_classes + 2)):
        for restart in range(n_restarts):
            if init is not None:
                d0 = init[t, restart].to(device=x0.device, dtype=x0.dtype)
            else:
                d0 = G.init_deltas(gen, B, region.red_ellipse, lin_comb=True,
                                   on_surface=True)
            adv, res2 = single_run(d0, order[:, -target_class])
            found = res2 < 1e10
            fooled = (logits_fn(adv).argmax(dim=1) != labels) & found & \
                pred_mask
            take = fooled & (res2 < best_res)
            best = torch.where(take[:, None], adv, best)
            best_res = torch.where(take, res2, best_res)
            success = success | take
    return FABResult(best, success, G.sq_distance_diag(mat, best))
