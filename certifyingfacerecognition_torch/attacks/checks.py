"""Defense sanity checks run before attack evaluation (port of
certifyingfacerecognition_tpu/attacks/checks.py): warnings that flag
conditions which make a white-box evaluation unreliable.

  * randomized defense: repeated evaluations of the same point must agree;
  * probability-shaped outputs: attacks expect logits, and softmax outputs
    flatten gradients;
  * zero gradients: dead gradient points break gradient-based attacks;
  * square success-rate anomaly: a score-based attack beating every
    gradient attack suggests gradient masking.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch


def _warn(msg: str, logger=None) -> None:
    if logger is None:
        warnings.warn(Warning(msg))
    else:
        logger.info(f"Warning: {msg}")


def _numpy(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(
        t, torch.Tensor) else np.asarray(t)


@torch.no_grad()
def check_randomized(logits_fn: Callable, x: torch.Tensor, y: torch.Tensor,
                     n: int = 5, alpha: float = 1e-4, logger=None) -> bool:
    """Repeated forwards must give identical accuracy and (normalised)
    outputs. Returns True if randomization is detected."""
    outs, corr = [], []
    y = _numpy(y)
    for _ in range(n):
        out = _numpy(logits_fn(x))
        corr.append(int((out.argmax(1) == y).sum()))
        outs.append(out / (np.linalg.norm(out, axis=1, keepdims=True)
                           + 1e-10))
    max_diff = 0.0
    for a in range(n - 1):
        for b in range(a + 1, n):
            max_diff = max(max_diff, float(
                np.linalg.norm(outs[a] - outs[b], axis=1).max()))
    randomized = any(c != corr[-1] for c in corr) or max_diff > alpha
    if randomized:
        _warn("it seems to be a randomized defense! Attack results may be "
              "unreliable; evaluate with multiple seeds.", logger)
    return randomized


@torch.no_grad()
def check_range_output(logits_fn: Callable, x: torch.Tensor,
                       alpha: float = 1e-5, logger=None) -> bool:
    """Detect probability-shaped outputs. Returns True if the output looks
    like a distribution."""
    out = _numpy(logits_fn(x))
    looks_prob = (out.max() < 1.0 + alpha and out.min() > -alpha
                  and np.all(np.abs(out.sum(-1) - 1.0) < alpha))
    if looks_prob:
        _warn("it seems that the output is a probability distribution; "
              "be sure the attacks receive logits!", logger)
    return bool(looks_prob)


def check_zero_gradients(grad: torch.Tensor, logger=None) -> int:
    """Count the samples whose gradient is identically zero."""
    g = _numpy(grad).reshape(grad.shape[0], -1)
    n_zero = int((np.abs(g).sum(-1) == 0).sum())
    if n_zero:
        _warn(f"there are {n_zero} points with zero gradient! Gradient-"
              "based attacks may be unreliable there.", logger)
    return n_zero


def check_square_sr(acc_dict: Dict[str, float], alpha: float = 0.002,
                    logger=None) -> bool:
    """Score-based Square beating every gradient attack indicates gradient
    masking. acc_dict: attack -> robust accuracy."""
    if "square" not in acc_dict or len(acc_dict) <= 2:
        return False
    best_grad = min(v for k, v in acc_dict.items() if k != "square")
    if acc_dict["square"] < best_grad - alpha:
        _warn(f"Square Attack decreased robust accuracy by "
              f"{best_grad - acc_dict['square']:.2%} vs gradient attacks — "
              "possible gradient masking; consider more Square iterations "
              "or an adaptive attack.", logger)
        return True
    return False


def check_retracing(fn, inputs, n: int = 3, logger=None) -> bool:
    """The JAX package's analogue of the dynamic-defense check counts jit
    cache misses of a jitted model on identical input shapes, and returns
    False for a callable without a jit cache. An eager PyTorch model has
    no such cache, so nothing here can re-trace: always False, as the JAX
    package answers for a plain callable."""
    return False


def run_all_checks(logits_fn: Callable, x: torch.Tensor, y: torch.Tensor,
                   grad_fn: Optional[Callable] = None, logger=None
                   ) -> Dict[str, bool]:
    """The pre-attack check battery."""
    results = {
        "randomized": check_randomized(logits_fn, x, y, logger=logger),
        "prob_output": check_range_output(logits_fn, x, logger=logger),
    }
    if grad_fn is not None:
        results["zero_grad"] = bool(
            check_zero_gradients(grad_fn(x), logger=logger))
    return results
