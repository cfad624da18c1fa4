"""Embedding-space distances and the gallery classifier head (port of
certifyingfacerecognition_tpu/ops/distances.py).

ArcFace ('insightface') uses the exact Euclidean distance; FaceNet the
cosine distance 1 - e1 . e2. The [B, N] distance matrix is computed by
matmul (||x||^2 + ||y||^2 - 2xy); where the decision (argmin) must be
exact, a top-k candidate set is re-ranked with the elementwise formula.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..constants import EMB_SIZE


def sq_euclidean_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances [B, N] via the matmul expansion."""
    xx = (x * x).sum(-1, keepdim=True)                   # [B, 1]
    yy = (y * y).sum(-1)[None, :]                        # [1, N]
    xy = x @ y.t()                                       # [B, N]
    return torch.clamp(xx + yy - 2.0 * xy, min=0.0)


class _SafeSqrt(torch.autograd.Function):
    """sqrt whose gradient is 0 where its input is 0 (the JAX package's
    _safe_sqrt): at a sample's own gallery entry the distance can be
    exactly 0 (PGD without random init), where the gradient of a plain
    sqrt is inf and poisons the whole attack."""

    @staticmethod
    def forward(ctx, d2):
        d = torch.sqrt(d2)
        ctx.save_for_backward(d2, d)
        return d

    @staticmethod
    def backward(ctx, grad):
        d2, d = ctx.saved_tensors
        pos = d2 > 0
        return torch.where(pos, 0.5 / torch.where(pos, d, 1.0), 0.0) * grad


def cdist(x: torch.Tensor, y: torch.Tensor, method: str = "insightface"
          ) -> torch.Tensor:
    """Distance matrix [B, N] with the metric of each FRS."""
    if method == "insightface":
        return _SafeSqrt.apply(sq_euclidean_matmul(x, y))
    return 1.0 - x @ y.t()


def pairwise_dists(x: torch.Tensor, y: torch.Tensor,
                   method: str = "insightface") -> torch.Tensor:
    """Row-wise distances [B]."""
    if method == "insightface":
        return torch.linalg.vector_norm(x - y, dim=-1)
    return 1.0 - (x * y).sum(-1)


def nearest_refined(x: torch.Tensor, gallery: torch.Tensor,
                    method: str = "insightface", k: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact nearest neighbour: (distance [B], index [B]).

    For 'insightface' the k nearest by matmul distance are re-ranked by the
    exact elementwise squared distance (returned); ties go to the lowest
    gallery index, and a row whose distances are all NaN keeps the argmin
    candidate, so the index is always in range."""
    if method != "insightface":
        d = cdist(x, gallery, method)
        idx = torch.argmin(d, dim=1)
        return d.gather(1, idx[:, None])[:, 0], idx
    n = gallery.shape[0]
    d2 = sq_euclidean_matmul(x, gallery)
    idx = torch.topk(d2, min(k, n), dim=1, largest=False).indices  # [B, k]
    diff = x[:, None, :] - gallery[idx]
    d_exact = (diff * diff).sum(-1)                      # [B, k]
    best = torch.argmin(d_exact, dim=1, keepdim=True)
    d_best = d_exact.gather(1, best)                     # [B, 1]
    tie = torch.where(d_exact == d_best, idx, n).min(dim=1).values
    win = torch.where(tie == n, idx.gather(1, best)[:, 0], tie)
    return d_best[:, 0], win


def argmin_dist_refined(x: torch.Tensor, gallery: torch.Tensor,
                        method: str = "insightface", k: int = 8
                        ) -> torch.Tensor:
    """Exact argmin-distance identity prediction [B]."""
    return nearest_refined(x, gallery, method, k)[1]


def probs_from_dists(dists: torch.Tensor, scale_dists: bool = True
                     ) -> torch.Tensor:
    """softmax(-d / sqrt(512)) over the gallery axis."""
    if scale_dists:
        dists = dists / np.sqrt(EMB_SIZE)
    return torch.softmax(-dists, dim=1)
