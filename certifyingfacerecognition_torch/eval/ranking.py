"""Attribute-importance ranking and attack-result aggregation (a copy of
certifyingfacerecognition_tpu/eval/ranking.py; numpy and scipy on the
host). Mirrors the reference's gen_utils.py:
  * get_ranking — iterative Friedman chi-square elimination with weighted
    votes plus pairwise Wilcoxon p-values (gen_utils.py:441-525);
  * aggregate_results — merge per-chunk logs into total success rate and
    average magnitude (gen_utils.py:528-549);
  * delta component statistics + acc-vs-budget curve (gen_utils.py:551-604).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.stats import friedmanchisquare, wilcoxon

from ..constants import ATTRS


def get_ranking(norm_comps: np.ndarray, attr_names: Sequence[str],
                alpha: float = 0.05):
    """norm_comps: [n_deltas, n_attrs] normalised component contributions.

    Returns (failed, ranking, pvals). Exact logic of gen_utils.py:441-525:
    repeated Friedman tests eliminate the top-ranked attribute by weighted
    votes (weights 1 - value, argsorted descending); the final pair is
    ordered by one-sided Wilcoxon.
    """
    data = {name: norm_comps[:, i] for i, name in enumerate(attr_names)}
    n_attr = len(data)
    data_copy = dict(data)
    ranking: List[str] = []
    failed = False

    for _ in range(n_attr - 2):
        n_attrs = len(data_copy)
        pval = friedmanchisquare(*data_copy.values()).pvalue
        if pval < alpha:
            curr = np.stack(list(data_copy.values()), axis=1)
            argsort = np.argsort(-curr, axis=1)
            weights = np.take_along_axis(1 - curr, argsort, axis=1)
            votes = np.zeros(n_attrs)
            for attr_idx in range(n_attrs):
                votes[attr_idx] = ((argsort == attr_idx) * weights).sum()
            winner = list(data_copy.keys())[int(votes.argmin())]
            ranking.append(winner)
            data_copy.pop(winner)
        else:
            failed = True
            break

    if not failed:
        k1, k2 = list(data_copy.keys())
        pval = wilcoxon(x=data[k1], y=data[k2], alternative="two-sided").pvalue
        if pval > alpha:
            ranking.extend([k1, k2])
        else:
            last_pval = wilcoxon(x=data[k1], y=data[k2],
                                 alternative="greater").pvalue
            if last_pval < alpha:
                ranking.extend([k1, k2])
            else:
                ranking.extend([k2, k1])

    if failed:
        return True, None, None

    pvals = []
    for idx in range(n_attr - 1):
        pvals.append(wilcoxon(x=data[ranking[idx]], y=data[ranking[idx + 1]],
                              alternative="greater").pvalue)
    return False, ranking, pvals


def delta_components(deltas: np.ndarray, magnitudes: np.ndarray,
                     epsilons: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-attribute squared components and their normalised contributions
    (gen_utils.py:560-567, incl. the consistency asserts)."""
    if epsilons is None:
        epsilons = np.array(list(ATTRS.values()))
    comps = deltas**2 / epsilons[None, :] ** 2
    norm_comps = comps / magnitudes[:, None]
    assert np.allclose(magnitudes, comps.sum(1), rtol=1e-4, atol=1e-5)
    assert np.allclose(norm_comps.sum(1), 1.0, rtol=1e-4, atol=1e-5)
    return comps, norm_comps


def aggregate_results(chunk_stats: Sequence[Dict[str, float]]
                      ) -> Dict[str, float]:
    """Combine per-chunk {successes, instances, avg_mags} dicts
    (gen_utils.py:528-549)."""
    tot_instances, tot_successes, tot_magnitudes = 0, 0, 0.0
    for data in chunk_stats:
        tot_instances += int(data["instances"])
        succ = float(data["successes"])
        tot_successes += int(succ)
        tot_magnitudes += float(data["avg_mags"]) * succ
    rate = 100.0 * tot_successes / tot_instances if tot_instances else 0.0
    avg_mag = tot_magnitudes / tot_successes if tot_successes else 0.0
    return {
        "successes": tot_successes,
        "instances": tot_instances,
        "rate": rate,
        "avg_mag": avg_mag,
    }


def accuracy_vs_budget(magnitudes: np.ndarray, tot_instances: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Accuracy-vs-perturbation-budget curve (gen_utils.py:580-590)."""
    dists = np.sqrt(magnitudes)
    N = dists.shape[0]
    maxx = np.quantile(dists, 0.99)
    lins = np.linspace(0, maxx, N)
    counts = (dists[:, None] > lins[None, :]).sum(0)
    return lins, counts / tot_instances
