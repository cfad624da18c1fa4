"""Attack losses over gallery distances (port of
certifyingfacerecognition_tpu/attacks/losses.py).

Sign conventions are the reference's: the optimiser MINIMISES the loss, so
e.g. xent returns the negated cross-entropy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import EMB_SIZE


def compute_loss(all_dists: torch.Tensor, labels: torch.Tensor,
                 loss_type: str = "away", use_probs: bool = True,
                 scale_dists: bool = True) -> torch.Tensor:
    """all_dists: [B, N] distances; labels: [B] int. Returns a scalar."""
    rows = torch.arange(all_dists.shape[0], device=all_dists.device)

    if use_probs:
        # The reference reassigns all_dists here, so the xent branch below
        # scales a second time; kept as it is.
        if scale_dists:
            all_dists = all_dists / np.sqrt(EMB_SIZE)
        vals = torch.softmax(-all_dists, dim=1)
    else:
        vals = all_dists

    target_val = vals[rows, labels]
    fill = -1.0 if use_probs else float("inf")
    mod_vals = vals.scatter(1, labels[:, None], fill)
    if use_probs:
        nearest_val = mod_vals.max(dim=1).values
    else:
        nearest_val = mod_vals.min(dim=1).values

    if loss_type == "away":
        return (1.0 if use_probs else -1.0) * target_val.mean()
    if loss_type == "nearest":
        return (-1.0 if use_probs else 1.0) * nearest_val.mean()
    if loss_type == "diff":
        return (1.0 if use_probs else -1.0) * (target_val
                                               - nearest_val).mean()
    if loss_type == "xent":
        assert use_probs, "xent loss should be used together with probs"
        scores = -(all_dists / np.sqrt(EMB_SIZE) if scale_dists
                   else all_dists)
        xent = -torch.log_softmax(scores, dim=1)[rows, labels]
        return -1.0 * xent.mean()
    if loss_type == "dlr":
        assert not use_probs, "dlr loss works in terms of logits"
        diff1 = target_val - nearest_val
        top = torch.topk(-all_dists, 3, dim=1).values
        return -1.0 * (diff1 / (top[:, 0] - top[:, 2])).mean()
    raise ValueError(f"unknown loss type: {loss_type}")


def dlr_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample DLR loss."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    srt = torch.sort(logits, dim=1).values
    ind = (logits.argmax(dim=1) == y).to(logits.dtype)
    num = logits[rows, y] - srt[:, -2] * ind - srt[:, -1] * (1.0 - ind)
    den = srt[:, -1] - srt[:, -3] + 1e-12
    return -num / den


def dlr_loss_targeted(logits: torch.Tensor, y: torch.Tensor,
                      y_target: torch.Tensor) -> torch.Tensor:
    """Per-sample targeted DLR loss."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    srt = torch.sort(logits, dim=1).values
    num = logits[rows, y] - logits[rows, y_target]
    den = srt[:, -1] - 0.5 * (srt[:, -3] + srt[:, -4]) + 1e-12
    return -num / den


def ce_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample cross-entropy (positive)."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return -torch.log_softmax(logits, dim=1)[rows, y]
