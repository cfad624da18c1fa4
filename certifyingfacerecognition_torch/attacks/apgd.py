"""AutoPGD (APGD / APGD-targeted) under the Sigma-ellipsoid norm (port of
certifyingfacerecognition_tpu/attacks/apgd.py).

Per restart: the momentum step (a = 0.75), the double re-projection onto
{||d||_Sigma <= eps = 1}, the oscillation-based step halving with
best-point restoration and the ce / dlr / targeted-dlr losses, with the
JAX package's semantics (an on-surface ellipsoid initialisation and
diagonal Sigma-norms throughout).

The iteration loop is a Python loop over tensors that stay on the device:
the check schedule (counter, window length) is host arithmetic that does
not depend on the data, and every per-sample decision is a torch.where,
so no iteration reads a value back to the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops import geometry as G
from .losses import ce_loss, dlr_loss, dlr_loss_targeted


class APGDResult(NamedTuple):
    deltas: torch.Tensor      # [B, k] adversarial deltas (x_best_adv)
    success: torch.Tensor     # [B] bool (~robust)
    magnitudes: torch.Tensor  # [B] squared Sigma-norms


def _loss_fn(loss: str) -> Callable:
    if loss == "ce":
        return lambda logits, y, y_t: ce_loss(logits, y)
    if loss == "dlr":
        return lambda logits, y, y_t: dlr_loss(logits, y)
    if loss == "dlr-targeted":
        return dlr_loss_targeted
    raise ValueError(f"unknown loss {loss}")


def _init(gen, B, region, init, index):
    """The initial deltas of one run: init[index] when draws are injected,
    else an on-surface draw from ``gen``."""
    if init is not None:
        return init[index].to(device=region.red_ellipse_diag.device,
                              dtype=torch.float32)
    return G.init_deltas(gen, B, region.red_ellipse, lin_comb=True,
                         on_surface=True)


@torch.no_grad()
def _attack_single_run(logits_fn: Callable, labels: torch.Tensor,
                       y_target: Optional[torch.Tensor],
                       deltas0: torch.Tensor, region: G.RegionMatrices, *,
                       n_iter: int, loss: str, eps: float = 1.0,
                       rho: float = 0.75):
    """One APGD run from ``deltas0`` [B, k]; returns (x_best, acc,
    loss_best, x_best_adv)."""
    B = labels.shape[0]
    mat = region.red_ellipse_diag
    crit = _loss_fn(loss)
    y_t = y_target if y_target is not None else torch.zeros_like(labels)

    n_iter_2 = max(int(0.22 * n_iter), 1)
    n_iter_min = max(int(0.06 * n_iter), 1)
    size_decr = max(int(0.03 * n_iter), 1)

    def lp_norm(v):
        return torch.sqrt(torch.clamp(G.sq_distance_diag(mat, v),
                                      min=0.0))[:, None]

    def normalize(v):
        return v / (lp_norm(v) + 1e-12)

    def grad_fn(x_adv):
        x = x_adv.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = logits_fn(x)
            li = crit(logits, labels, y_t)
            (grad,) = torch.autograd.grad(li.sum(), x)
        return li.detach(), logits.detach(), grad

    x_adv = deltas0                    # the deltas-as-images origin is 0
    loss_best, logits, grad = grad_fn(x_adv)
    acc = logits.argmax(dim=1) == labels
    x_best = x_best_adv = x_adv_old = x_adv
    grad_best = grad
    step_size = torch.full((B, 1), 2.0 * eps, device=x_adv.device)
    loss_steps = torch.zeros((n_iter, B), device=x_adv.device)
    counter3, k_ctr = 0, n_iter_2
    loss_best_last_check = loss_best
    reduced_last_check = torch.ones((B,), device=x_adv.device)
    cs = torch.arange(n_iter_2, device=x_adv.device)

    for i in range(n_iter):
        grad2 = x_adv - x_adv_old
        x_adv_old = x_adv
        a = 0.75 if i > 0 else 1.0

        z = x_adv + step_size * normalize(grad)
        z = normalize(z) * torch.clamp(lp_norm(z), max=eps)
        z = x_adv + (z - x_adv) * a + grad2 * (1.0 - a)
        x_adv = normalize(z) * torch.clamp(lp_norm(z), max=eps)

        loss_indiv, logits, grad = grad_fn(x_adv)
        pred = logits.argmax(dim=1) == labels
        acc = acc & pred
        x_best_adv = torch.where(pred[:, None], x_best_adv, x_adv)

        loss_steps[i] = loss_indiv
        improved = loss_indiv > loss_best
        x_best = torch.where(improved[:, None], x_adv, x_best)
        grad_best = torch.where(improved[:, None], grad, grad_best)
        loss_best = torch.where(improved, loss_indiv, loss_best)

        counter3 += 1
        if counter3 != k_ctr:
            continue
        # t_b = #{c < k_ctr : loss[i-c] > loss[i-c-1]}; negative history
        # indices wrap to the (still-zero) trailing rows, as the
        # reference's python negative indexing does
        idx = i - cs
        newer = loss_steps[idx % n_iter]
        older = loss_steps[(idx - 1) % n_iter]
        valid = (cs < k_ctr)[:, None]
        t = ((newer > older) & valid).sum(0).float()
        fl_osc = t <= k_ctr * rho
        fl_no_impr = (1.0 - reduced_last_check) * (
            loss_best_last_check >= loss_best)
        halve = torch.maximum(fl_osc.float(), fl_no_impr) > 0

        step_size = torch.where(halve[:, None], step_size / 2.0, step_size)
        x_adv = torch.where(halve[:, None], x_best, x_adv)
        grad = torch.where(halve[:, None], grad_best, grad)
        k_ctr = max(k_ctr - size_decr, n_iter_min)
        counter3 = 0
        reduced_last_check = halve.float()
        loss_best_last_check = loss_best

    return x_best, acc, loss_best, x_best_adv


@torch.no_grad()
def apgd_attack(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    labels: torch.Tensor,
    gen: torch.Generator,
    region: G.RegionMatrices,
    *,
    loss: str = "ce",               # 'ce' | 'dlr' (untargeted)
    n_iter: int = 100,
    n_restarts: int = 1,
    eps: float = 1.0,
    init: Optional[torch.Tensor] = None,
) -> APGDResult:
    """Untargeted APGD (apgd-ce / apgd-dlr): per restart, samples still
    robust get the new adversarial point. ``init`` [n_restarts, B, k],
    when given, replaces the random initial deltas of each restart."""
    B = labels.shape[0]
    x = torch.zeros((B, region.dirs.shape[1]), device=labels.device)
    acc = logits_fn(x).argmax(dim=1) == labels
    adv = x
    for counter in range(n_restarts):
        _, acc_curr, _, adv_curr = _attack_single_run(
            logits_fn, labels, None, _init(gen, B, region, init, counter),
            region, n_iter=n_iter, loss=loss, eps=eps)
        # the first successful adversary is kept; initially misclassified
        # samples keep the clean point
        newly = ~acc_curr & acc
        adv = torch.where(newly[:, None], adv_curr, adv)
        acc = acc & acc_curr
    return APGDResult(adv, ~acc, G.sq_distance_diag(region.red_ellipse_diag,
                                                    adv))


@torch.no_grad()
def apgd_targeted_attack(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    labels: torch.Tensor,
    gen: torch.Generator,
    region: G.RegionMatrices,
    *,
    n_iter: int = 100,
    n_restarts: int = 1,
    n_target_classes: int = 9,
    eps: float = 1.0,
    init: Optional[torch.Tensor] = None,
) -> APGDResult:
    """Targeted APGD on the targeted DLR loss over the 2nd..(T+1)-th
    nearest classes. ``init`` [n_target_classes, n_restarts, B, k], when
    given, replaces the random initial deltas of each run."""
    B = labels.shape[0]
    x = torch.zeros((B, region.dirs.shape[1]), device=labels.device)
    logits0 = logits_fn(x)
    acc = logits0.argmax(dim=1) == labels
    # stable, as jnp.argsort: ties keep the JAX package's target order
    order = torch.argsort(logits0, dim=1, stable=True)
    adv = x
    for t, target_class in enumerate(range(2, n_target_classes + 2)):
        y_target = order[:, -target_class]
        for counter in range(n_restarts):
            d0 = _init(gen, B, region, None if init is None else init[t],
                       counter)
            _, acc_curr, _, adv_curr = _attack_single_run(
                logits_fn, labels, y_target, d0, region, n_iter=n_iter,
                loss="dlr-targeted", eps=eps)
            newly = ~acc_curr & acc
            adv = torch.where(newly[:, None], adv_curr, adv)
            acc = acc & acc_curr
    return APGDResult(adv, ~acc, G.sq_distance_diag(region.red_ellipse_diag,
                                                    adv))
