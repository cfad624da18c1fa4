"""Score-based (gradient-free) random-search attack on the semantic
ellipsoid, the Lsigma2 counterpart of the Square attack (port of
certifyingfacerecognition_tpu/attacks/square.py).

Each iteration perturbs one random attribute coordinate of every sample's
delta by a budget-scaled signed step (the 1-D analogue of a square),
projects back onto the Sigma-ellipsoid and keeps the proposal only when
the margin loss improves. Only forward evaluations are used. The step
scale decays piecewise, as Square's p_selection schedule does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..ops import geometry as G


class SquareResult(NamedTuple):
    deltas: torch.Tensor      # [B, k]
    success: torch.Tensor     # [B] bool
    magnitudes: torch.Tensor  # [B] squared Sigma-norms


def _margin(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logit_y - max_{c != y} logit_c; adversarial iff negative."""
    target = logits.gather(1, labels[:, None])[:, 0]
    others = logits.scatter(1, labels[:, None], float("-inf"))
    return target - others.max(dim=1).values


def _step_scale(i: int, n_iter: int) -> float:
    """Piecewise-decaying exploration scale of iteration i."""
    frac = i / max(n_iter, 1)
    for limit, scale in ((0.1, 1.0), (0.3, 0.5), (0.6, 0.25), (0.8, 0.12)):
        if frac < limit:
            return scale
    return 0.06


def draw_square(gen: torch.Generator, B: int, k: int, n_iter: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One restart's proposals: coordinates [n_iter, B] in [0, k) and
    signs [n_iter, B] in {-1, +1} (f32), drawn on the CPU from ``gen``."""
    coords = torch.randint(0, k, (n_iter, B), generator=gen)
    signs = torch.randint(0, 2, (n_iter, B), generator=gen) * 2.0 - 1.0
    return coords, signs


@torch.no_grad()
def square_attack(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    labels: torch.Tensor,
    gen: torch.Generator,
    region: G.RegionMatrices,
    *,
    n_iter: int = 100,
    n_restarts: int = 1,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> SquareResult:
    """Random-search attack in delta space [B, k] under the reduced
    (diagonal) Sigma-ellipsoid; returns the first successful delta per
    sample. ``draws`` = (initial deltas [n_restarts, B, k], coordinates
    [n_restarts, n_iter, B], signs [n_restarts, n_iter, B]), when given,
    replaces the random draws."""
    B = labels.shape[0]
    ell = region.red_ellipse
    k = region.red_ellipse_diag.shape[0]
    device = labels.device
    budgets = 1.0 / torch.sqrt(region.red_ellipse_diag)   # semi-axes [k]
    rows = torch.arange(B, device=device)

    def eval_margin(deltas):
        return _margin(logits_fn(deltas), labels)

    best = torch.zeros((B, k), device=device)
    found = torch.zeros((B,), dtype=torch.bool, device=device)
    for r in range(n_restarts):
        if draws is not None:
            deltas = draws[0][r].to(device=device, dtype=torch.float32)
            coords, signs = draws[1][r], draws[2][r]
        else:
            deltas = G.init_deltas(gen, B, ell, proj_mat=None,
                                   random_init=True, lin_comb=True,
                                   on_surface=True)
            coords, signs = draw_square(gen, B, k, n_iter)
        coords = coords.to(device=device, dtype=torch.int64)
        signs = signs.to(device=device, dtype=torch.float32)
        margin = eval_margin(deltas)
        success = margin < 0
        best = torch.where((success & ~found)[:, None], deltas, best)
        found = found | success
        for i in range(n_iter):
            coord = coords[i]
            step = _step_scale(i, n_iter) * signs[i] * budgets[coord]
            prop = deltas.clone()
            prop[rows, coord] = deltas[rows, coord] + step
            prop = G.proj2region(prop, None, ell, to_subs=False,
                                 on_surface=False)
            new_margin = eval_margin(prop)
            accept = new_margin < margin
            deltas = torch.where(accept[:, None], prop, deltas)
            margin = torch.where(accept, new_margin, margin)
            success = margin < 0
            best = torch.where((success & ~found)[:, None], deltas, best)
            found = found | success
    return SquareResult(best, found,
                        G.sq_distance_diag(region.red_ellipse_diag, best))
