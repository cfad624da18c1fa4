"""Latent-space PGD with semantic-ellipsoid projection (port of
certifyingfacerecognition_tpu/attacks/pgd.py).

Semantics kept from the JAX package and the reference:
  * success is evaluated on the *current* deltas before each step
    (including the initial ones), from the argmin of the same forward's
    distances, and the first successful delta per sample is kept;
  * the loss is the batch mean (gradients scale by 1/B; the default
    lr=1e2 compensates);
  * after the last evaluated iterate one more (unused) step is taken;
  * the optimiser state is reset at each restart, and the deltas are
    projected back into the feasible region after every step.

Spans (utils/profiling.span): ``attack.step`` over each iterate, and
inside it ``attack.backward`` (the gradient, with the checkpoint's
recompute), ``attack.update`` (the success bookkeeping and the optimiser
step) and ``attack.project``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..constants import EMB_SIZE
from ..ops import geometry as G
from ..utils.profiling import span
from .losses import compute_loss


class PGDResult(NamedTuple):
    best_deltas: torch.Tensor   # [B, k] (or [B, 512] if not lin_comb)
    found: torch.Tensor         # [B] bool
    magnitudes: torch.Tensor    # [B] squared Sigma-norms of best_deltas


class _Optimizer:
    """The JAX package's optax optimisers, written out with optax's
    operation order: SGD with a momentum trace (t = g + momentum t),
    Adam (bias-corrected moments, eps outside the sqrt) and RMSProp with
    eps outside the sqrt (torch.optim.RMSprop's form)."""

    def __init__(self, name: str, lr: float, momentum: float):
        if name not in ("SGD", "Adam", "RMSProp"):
            raise ValueError(f"unknown optimizer {name}")
        self.name, self.lr, self.momentum = name, lr, momentum

    def init(self, params: torch.Tensor) -> dict:
        z = torch.zeros_like(params)
        return {"count": 0, "m": z, "v": z.clone()}

    def step(self, params, grads, state) -> torch.Tensor:
        """Return the updated params; advance ``state`` in place."""
        if self.name == "SGD":
            state["m"] = grads + self.momentum * state["m"]
            upd = state["m"]
        elif self.name == "Adam":
            b1, b2 = 0.9, 0.999
            state["count"] += 1
            state["m"] = (1 - b1) * grads + b1 * state["m"]
            state["v"] = (1 - b2) * grads ** 2 + b2 * state["v"]
            t = torch.tensor(float(state["count"]))
            m_hat = state["m"] / (1 - torch.tensor(b1) ** t).to(params)
            v_hat = state["v"] / (1 - torch.tensor(b2) ** t).to(params)
            upd = m_hat / (torch.sqrt(v_hat) + 1e-8)
        else:
            decay = 0.99
            state["v"] = (1 - decay) * grads ** 2 + decay * state["v"]
            upd = 1 / (torch.sqrt(state["v"]) + 1e-8) * grads
        return params + (-self.lr) * upd


def make_optimizer(opt_name: str, lr: float, momentum: float = 0.9
                   ) -> _Optimizer:
    return _Optimizer(opt_name, lr, momentum)


def find_adversaries_pgd(
    dists_fn: Callable[[torch.Tensor], torch.Tensor],
    lat_codes: torch.Tensor,           # [B, 512]
    labels: torch.Tensor,              # [B] int64
    gen: torch.Generator,
    region: G.RegionMatrices,
    *,
    opt_name: str = "SGD",
    lr: float = 1e2,
    iters: int = 10,
    momentum: float = 0.9,
    loss_type: str = "xent",
    lin_comb: bool = True,
    random_init: bool = True,
    rand_init_on_surf: bool = True,
    restarts: int = 5,
    init: Optional[torch.Tensor] = None,
) -> PGDResult:
    """dists_fn maps perturbed latents [B, 512] to gallery distances
    [B, N] (differentiable). ``init`` [restarts, B, d], when given,
    replaces the random initial deltas of each restart. Returns the first
    successful delta per sample."""
    B = lat_codes.shape[0]
    ell = region.red_ellipse if lin_comb else region.ellipse
    delta_dim = region.dirs.shape[1] if lin_comb else EMB_SIZE
    opt = make_optimizer(opt_name, lr, momentum)
    dirs_t = region.dirs.t()
    device = lat_codes.device

    def project(deltas):
        if lin_comb:
            return G.proj2region(deltas, None, ell, to_subs=False,
                                 on_surface=False)
        return G.proj2region(deltas, region.proj_mat, ell, to_subs=True,
                             on_surface=False)

    best = torch.zeros((B, delta_dim), dtype=torch.float32, device=device)
    found = torch.zeros((B,), dtype=torch.bool, device=device)
    for r in range(restarts):
        if init is not None:
            deltas = init[r].to(device=device, dtype=torch.float32)
        else:
            deltas = G.init_deltas(
                gen, B, ell, proj_mat=None if lin_comb else region.proj_mat,
                random_init=random_init, lin_comb=lin_comb,
                on_surface=rand_init_on_surf)
        state = opt.init(deltas)
        for _ in range(iters):
            with span("attack.step", outer=True):
                d = deltas.detach().requires_grad_(True)
                with torch.enable_grad():
                    pert = G.matmul_f32(d, dirs_t) if lin_comb else d
                    dists = dists_fn(lat_codes + pert)
                    loss = compute_loss(dists, labels, loss_type=loss_type,
                                        use_probs=loss_type != "dlr")
                    with span("attack.backward", exclusive=True):
                        (grads,) = torch.autograd.grad(loss, d)
                with torch.no_grad():
                    with span("attack.update"):
                        success = dists.argmin(dim=1) != labels
                        best = torch.where((success & ~found)[:, None],
                                           deltas, best)
                        found = found | success
                        stepped = opt.step(deltas, grads, state)
                    with span("attack.project"):
                        deltas = project(stepped)
    return PGDResult(best, found, check_deltas(best, region, lin_comb))


def check_deltas(deltas: torch.Tensor, region: G.RegionMatrices,
                 lin_comb: bool = True) -> torch.Tensor:
    """Squared Sigma-norms of the deltas."""
    if lin_comb:
        return G.sq_distance_diag(region.red_ellipse_diag, deltas)
    return G.sq_distance(region.ellipse.mat(), deltas)


def assert_deltas_feasible(deltas: torch.Tensor, region: G.RegionMatrices,
                           lin_comb: bool = True, atol: float = 1e-3
                           ) -> None:
    """Host-side validity check of the reference's asserts; raises."""
    if lin_comb:
        if not G.in_ellps(deltas, region.red_ellipse, atol=atol):
            raise AssertionError("deltas outside reduced ellipsoid")
    else:
        if not G.in_subs(deltas, region.proj_mat, atol=atol):
            raise AssertionError("deltas outside the subspace")
        if not G.in_ellps(deltas, region.ellipse, atol=atol):
            raise AssertionError("deltas outside the ellipsoid")
