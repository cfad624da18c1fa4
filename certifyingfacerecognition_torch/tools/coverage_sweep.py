"""Sequential-mode coverage sweep at the deployment configuration (port of
certifyingfacerecognition_tpu/tools/coverage_sweep.py).

Runs the real ``Smooth.certify_adaptive`` (no reimplementation of the
stopping rule) at the reference deployment point (N = 10,000, N0 = 100,
alpha = 0.001, batch 128, 8 batches per checkpoint) over a grid of true
success probabilities, with a threshold classifier whose success per
sample is exactly Bernoulli(p) in the smoothing noise (class 0 iff
noise[0] <= Phi^{-1}(p), sigma = 1). Per p it reports:

  * violations of the emitted bound: certifications whose Phi(gap)
    exceeds the true p. The alpha-spending union bound guarantees
    P(violation) <= alpha per identity;
  * the savings: mean and median samples used against the fixed
    estimator's N0 + N.

Trial t draws from ``identity_generator(0, t, device)``. Unlike the JAX
tool, which always runs on the CPU, this one runs on the card unless
``--device cpu`` is given.

Usage: python -m certifyingfacerecognition_torch.tools.coverage_sweep
Env: CS_PGRID ("0.55,0.75,0.9,0.99,0.999"), CS_TRIALS (1000), CS_N
(10000), CS_N0 (100), CS_ALPHA (0.001), CS_BATCH (128), CS_CHUNK (8),
CS_SLACK (0.1), CS_MODE (sequential). One JSON line per p and a summary.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from scipy.stats import norm


def make_bernoulli_smooth(p_true: float, batch_size: int, device="cuda"):
    """Smooth over a classifier whose success indicator under the N(0, I)
    smoothing noise is exactly Bernoulli(p_true) per sample."""
    from ..smoothing.certificate import L2Certificate
    from ..smoothing.smooth import Smooth

    tau = norm.ppf(p_true)

    def predict(z, p):
        return (p[:, 0] > tau).long()          # class 0 = success

    return Smooth(predict, num_classes=2, sigma=1.0,
                  certificate=L2Certificate(), noise_dim=5,
                  batch_size=batch_size, device=device)


def sweep_point(p_true: float, trials: int, n: int, n0: int, alpha: float,
                batch: int, chunk: int, slack: float, mode: str,
                base_seed: int = 0, device="cuda"):
    from ..smoothing.smooth import ABSTAIN, identity_generator
    from ..utils.device import device_name

    sm = make_bernoulli_smooth(p_true, batch, device)
    z, x = np.zeros(4), np.zeros(5)
    used, certified, abstained, rejected, violations = [], 0, 0, 0, 0
    t0 = time.time()
    for t in range(trials):
        pred, gap, n_used = sm.certify_adaptive(
            z, x, 0, n0, n, alpha, identity_generator(base_seed, t, device),
            mode=mode, chunk_batches=chunk, slack=slack)
        used.append(n_used)
        if pred == 0 and gap > 0:
            certified += 1
            if norm.cdf(gap) > p_true:
                violations += 1
        elif pred == ABSTAIN:
            abstained += 1
        else:
            rejected += 1
    return {
        "p_true": p_true, "mode": mode, "trials": trials,
        "N": n, "N0": n0, "alpha": alpha, "batch": batch,
        "chunk_batches": chunk, "slack": slack,
        "certified": certified, "abstain": abstained,
        "selection_rejected": rejected,
        "violations": violations,
        "violation_rate": round(violations / max(certified, 1), 6),
        "mean_samples": round(float(np.mean(used)), 1),
        "p50_samples": int(np.median(used)),
        "savings_vs_fixed": round((n0 + n) / float(np.mean(used)), 2),
        "wall_s": round(time.time() - t0, 1),
        "device": device_name(device),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"], help="cuda needs a CUDA GPU")
    args = p.parse_args(argv)
    grid = [float(v) for v in os.environ.get(
        "CS_PGRID", "0.55,0.75,0.9,0.99,0.999").split(",")]
    trials = int(os.environ.get("CS_TRIALS", "1000"))
    n = int(os.environ.get("CS_N", "10000"))
    n0 = int(os.environ.get("CS_N0", "100"))
    alpha = float(os.environ.get("CS_ALPHA", "0.001"))
    batch = int(os.environ.get("CS_BATCH", "128"))
    chunk = int(os.environ.get("CS_CHUNK", "8"))
    slack = float(os.environ.get("CS_SLACK", "0.1"))
    mode = os.environ.get("CS_MODE", "sequential")

    total_viol, total_cert = 0, 0
    for pv in grid:
        row = sweep_point(pv, trials, n, n0, alpha, batch, chunk, slack,
                          mode, device=args.device)
        total_viol += row["violations"]
        total_cert += row["certified"]
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "summary": {"total_certified": total_cert,
                    "total_violations": total_viol,
                    "alpha": alpha,
                    # Union-bound guarantee: per-identity violation
                    # probability <= alpha, so expected violations <=
                    # certified * alpha.
                    "expected_upper": round(total_cert * alpha, 2)},
        "device": row["device"]}), flush=True)


if __name__ == "__main__":
    main()
