"""Host-side statistical primitives for certification (scipy)."""

from __future__ import annotations

from scipy.stats import beta, binomtest, norm


def clopper_pearson_lower(k: int, n: int, alpha: float) -> float:
    """One-sided (1 - alpha) lower confidence bound on a Bernoulli p
    (statsmodels proportion_confint(k, n, 2*alpha, method='beta')[0])."""
    k = int(k)
    n = int(n)
    if k == 0:
        return 0.0
    return float(beta.ppf(alpha, k, n - k + 1))


def clopper_pearson_upper(k: int, n: int, alpha: float) -> float:
    k = int(k)
    n = int(n)
    if k == n:
        return 1.0
    return float(beta.isf(alpha, k + 1, n - k))


def binom_two_sided_pvalue(k: int, n: int, p: float = 0.5) -> float:
    """Two-sided exact binomial test."""
    return float(binomtest(int(k), int(n), p).pvalue)


def gaussian_quantile(p: float) -> float:
    """Phi^{-1}(p), the L2 certificate gap."""
    return float(norm.ppf(p))
