"""The device engine of adaptive certification (port of
certifyingfacerecognition_tpu/smoothing/adaptive_device.py).

Every stopping rule of both adaptive modes compares the running success
count ``n_a`` with the Clopper-Pearson geometry of the checkpoint, and the
bounds are monotone in ``n_a``. So the rules collapse to two integer
threshold tables (certify-emit / abstain), one entry per checkpoint,
computed once per (mode, n, batch, chunk, alpha, slack, gap_target) config
with vectorised scipy quantiles (``build_thresholds``, numpy/scipy, equal
entry for entry to the JAX package's).

The loop: each checkpoint's batches add their counts on the device; n_a,
m and the status are int32 tensors there, and the status comes from
comparing n_a with the thresholds, which sit on the device too. The host
reads one status per checkpoint to decide whether to launch the next one
(eager PyTorch has no device-side while loop), and the row
(c_a_hat, n_a, m, k_stop, status) once at the end. (Launching the next
checkpoint before reading the status, and discarding its counts after a
stop, measured slower on an H100: the batch wasted at each stop costs
more than the waits it saves; PERF.md §6.) The emitted gap is computed
on the host from the row with the host engine's scalar arithmetic, so the
two engines agree exactly wherever the rules are exactly monotone
(build_thresholds checks this, ``exact``): the one exception is
guaranteed mode with ``gap_target``, whose "provably below target" branch
decreases in n_a; there the device engine stops no earlier and emits a
gap at least as large, still valid.

Unlike the JAX program, batches that only pad the last checkpoint are not
run: they draw no noise and count nothing, so ``n_used`` is the same.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from scipy.stats import beta as _beta

from .smooth import ABSTAIN, batch_valid
from ..utils.stats import clopper_pearson_lower


def _cp_lower_vec(k: np.ndarray, n: int, alpha: float) -> np.ndarray:
    """Vectorized utils.stats.clopper_pearson_lower (same scipy call)."""
    k = np.asarray(k, np.int64)
    out = np.zeros(k.shape, np.float64)
    pos = k > 0
    out[pos] = _beta.ppf(alpha, k[pos], n - k[pos] + 1)
    return out


def _cp_upper_vec(k: np.ndarray, n: int, alpha: float) -> np.ndarray:
    """Vectorized utils.stats.clopper_pearson_upper (same scipy call)."""
    k = np.asarray(k, np.int64)
    out = np.ones(k.shape, np.float64)
    lt = k < n
    out[lt] = _beta.isf(alpha, k[lt] + 1, n - k[lt])
    return out


def _gap_vec(certificate, p: np.ndarray) -> np.ndarray:
    """certificate.compute_gap over an array (vectorized when available)."""
    fn = getattr(certificate, "compute_gap_vec", None)
    if fn is not None:
        return np.asarray(fn(p), np.float64)
    return np.array([certificate.compute_gap(float(v)) for v in p],
                    np.float64)


def _suffix_threshold(flags: np.ndarray):
    """Smallest t with flags[t:] all True (len(flags) if none); exact iff
    the True-set is precisely that suffix."""
    run = np.logical_and.accumulate(flags[::-1])
    t = len(flags) - int(run.sum())
    exact = bool(np.array_equal(flags, np.arange(len(flags)) >= t))
    return t, exact


def _prefix_threshold(flags: np.ndarray):
    """Largest t with flags[:t+1] all True (-1 if flags[0] is False); exact
    iff the True-set is precisely that prefix."""
    run = np.logical_and.accumulate(flags)
    t = int(run.sum()) - 1
    exact = bool(np.array_equal(flags, np.arange(len(flags)) <= t))
    return t, exact


@dataclass(frozen=True)
class ThresholdTable:
    """Per-checkpoint stopping thresholds for the device loop.

    At checkpoint k (cumulative valid samples ``m_k[k]``) the loop emits a
    certification iff n_a >= t_emit[k] and an abstention iff
    n_a <= t_abst[k]; both rule sets are exhaustive at the last checkpoint
    by construction. ``alpha_early``/``alpha_final`` reproduce the
    host engine's alpha-spending split for the post-hoc gap.
    """
    t_emit: np.ndarray        # int64 [K]
    t_abst: np.ndarray        # int64 [K]
    m_k: np.ndarray           # int64 [K] cumulative valid samples
    alpha_early: float
    alpha_final: float
    exact: bool               # all rules were exactly monotone in n_a


def build_thresholds(mode: str, n: int, valid: np.ndarray,
                     chunk_batches: int, alpha: float, certificate,
                     slack: float, gap_target) -> ThresholdTable:
    """Precompute the integer stopping thresholds for one adaptive config.

    ``valid`` is the padded per-batch valid-sample vector (length
    K * chunk_batches); the rules evaluated per checkpoint are EXACTLY
    those of Smooth.certify_adaptive (same scipy calls), reduced to
    thresholds via their monotonicity in n_a.
    """
    assert mode in ("guaranteed", "sequential"), mode
    valid = np.asarray(valid, np.int64)
    assert valid.size % chunk_batches == 0
    n_chunks = valid.size // chunk_batches
    m_k = np.cumsum(valid.reshape(n_chunks, chunk_batches).sum(axis=1))

    alpha_early = alpha / (2 * (n_chunks - 1)) if n_chunks > 1 else alpha
    alpha_final = alpha / 2 if n_chunks > 1 else alpha

    t_emit = np.zeros((n_chunks,), np.int64)
    t_abst = np.zeros((n_chunks,), np.int64)
    exact = True
    for k in range(n_chunks):
        m = int(m_k[k])
        last = k == n_chunks - 1
        n_a = np.arange(m + 1)
        with np.errstate(invalid="ignore"):
            if mode == "guaranteed":
                lb_lo = _cp_lower_vec(n_a, n, alpha)
                lb_hi = _cp_lower_vec(n_a + (n - m), n, alpha)
                abst = lb_hi < 0.5
                settled = lb_lo >= 0.5
                if last:
                    emit = settled
                else:
                    gap_lo = np.where(settled,
                                      _gap_vec(certificate,
                                               np.clip(lb_lo, 1e-300, 1)),
                                      -np.inf)
                    gap_hi = _gap_vec(certificate, np.clip(lb_hi, 1e-300, 1))
                    stop = gap_lo >= (1.0 - slack) * gap_hi
                    if gap_target is not None:
                        stop |= (gap_lo >= gap_target) | (gap_hi < gap_target)
                    emit = settled & stop
            else:
                a_k = alpha_final if last else alpha_early
                lb_k = _cp_lower_vec(n_a, m, a_k)
                abst = _cp_upper_vec(n_a, m, a_k) < 0.5
                settled = lb_k >= 0.5
                if last:
                    emit = settled
                else:
                    gap_k = np.where(settled,
                                     _gap_vec(certificate,
                                              np.clip(lb_k, 1e-300, 1)),
                                     -np.inf)
                    gap_best = _gap_vec(certificate, np.clip(
                        _cp_lower_vec(n_a + (n - m), n, alpha_final),
                        1e-300, 1))
                    stop = gap_k >= (1.0 - slack) * gap_best
                    if gap_target is not None:
                        stop |= gap_k >= gap_target
                    emit = settled & stop
        te, ex_e = _suffix_threshold(emit)
        ta, ex_a = _prefix_threshold(abst)
        if last:
            # Exhaustive final checkpoint: not-emitted => abstain, exactly
            # as the host engine's trailing `if last: return ABSTAIN`.
            ta = te - 1
            ex_a = True
        else:
            assert ta < te, (mode, k, ta, te)
        t_emit[k], t_abst[k] = te, ta
        exact = exact and ex_e and ex_a
    return ThresholdTable(t_emit, t_abst, m_k, alpha_early, alpha_final,
                          exact)


# Device-loop status codes (int32).
RUNNING, EMIT, ABSTAIN_STATUS, SELECTION_FAIL = 0, 1, 2, 3


def _run_core(smooth, z, x, label: int, generator, valid0, valid,
              chunk_batches: int, n_chunks: int, t_emit, t_abst,
              noise0=None, noise=None) -> torch.Tensor:
    """One identity: N0 selection, then the checkpoints, each adding its
    batches' counts to n_a on the device and comparing n_a with the
    thresholds; before each checkpoint the host reads the status. Returns
    the int32 row (c_a_hat, n_a, m, k_stop, status), still on the
    device."""
    dev = smooth.device

    def i32(v):                       # a fill, not a copy from the host
        return torch.full((), v, dtype=torch.int32, device=dev)

    running, emit, abstain = i32(RUNNING), i32(EMIT), i32(ABSTAIN_STATUS)
    counts0 = smooth._counts(z, x, valid0, generator, noise0)
    c_a_hat = counts0.argmax().to(torch.int32)
    status = torch.where(c_a_hat == int(label), running, i32(SELECTION_FAIL))
    n_a, m, k = i32(0), i32(0), 0
    while k < n_chunks and int(status) == RUNNING:     # one read
        sl = slice(k * chunk_batches, (k + 1) * chunk_batches)
        counts = smooth._counts(z, x, valid[sl], generator,
                                None if noise is None else noise[sl])
        n_a = n_a + counts[c_a_hat].to(torch.int32)
        m = m + int(valid[sl].sum())
        status = torch.where(n_a <= t_abst[k], abstain,
                             torch.where(n_a >= t_emit[k], emit, running))
        k += 1
    return torch.stack([c_a_hat, n_a, m, i32(k - 1), status])


def _loop_shapes(smooth, n0: int, n: int, chunk_batches: int):
    bs = smooth.batch_size
    n0_batches = math.ceil(n0 / bs)
    n_batches = math.ceil(n / bs)
    n_chunks = math.ceil(n_batches / chunk_batches)
    padded = n_chunks * chunk_batches
    valid0 = batch_valid(n0, bs)
    valid = np.zeros((padded,), np.int64)
    valid[:n_batches] = batch_valid(n, bs)
    return n0_batches, n_batches, n_chunks, padded, valid0, valid


def _get_tab(smooth, mode: str, n: int, valid, chunk_batches: int,
             alpha: float, slack: float, gap_target):
    """(ThresholdTable, t_emit, t_abst as int32 tensors on the device),
    built once per rule config."""
    tab_key = (mode, n, smooth.batch_size, chunk_batches, alpha, slack,
               gap_target, id(smooth.certificate))
    entry = smooth._adaptive_tab_cache.get(tab_key)
    if entry is None:
        tab = build_thresholds(mode, n, valid, chunk_batches, alpha,
                               smooth.certificate, slack, gap_target)
        entry = (tab, *(torch.as_tensor(t, dtype=torch.int32,
                                        device=smooth.device)
                        for t in (tab.t_emit, tab.t_abst)))
        smooth._adaptive_tab_cache[tab_key] = entry
    return entry


def _result_from_row(smooth, tab: ThresholdTable, mode: str, n0: int,
                     n: int, n_chunks: int, alpha: float, row):
    """(c_a_hat, n_a, m, k_stop, status) -> the host engine's
    (prediction, gap, n_used) tuple, same scalar arithmetic."""
    c_a_hat, n_a, m, k_stop, status = (int(v) for v in row)
    if status == SELECTION_FAIL:
        return c_a_hat, 0.0, n0
    if status == ABSTAIN_STATUS:
        return ABSTAIN, 0.0, n0 + m
    assert status == EMIT, status
    if mode == "guaranteed":
        gap = smooth.certificate.compute_gap(
            clopper_pearson_lower(n_a, n, alpha))
    else:
        a_k = (tab.alpha_final if k_stop == n_chunks - 1
               else tab.alpha_early)
        gap = smooth.certificate.compute_gap(
            clopper_pearson_lower(n_a, m, a_k))
    return c_a_hat, gap, n0 + m


def certify_adaptive_device_many(smooth, zs, xs, labels, n0: int, n: int,
                                 alpha: float, generators, mode: str,
                                 chunk_batches: int, slack: float,
                                 gap_target, pad_to: int = 0, noise0=None,
                                 noise=None):
    """Certify G identities one after another, each with its own generator
    (and optional injected noise, ``noise0[i]``/``noise[i]``) and its own
    early exit, with one read of the G result rows. Each identity's result
    equals a single-identity call's. ``pad_to`` (the JAX package's
    compile-shape bucket) has no effect: nothing is compiled per group
    size. Returns a list of G (prediction, gap, n_used) tuples."""
    g = len(labels)
    assert g >= 1 and len(zs) == len(xs) == len(generators) == g
    _, n_batches, n_chunks, _, valid0, valid = _loop_shapes(
        smooth, n0, n, chunk_batches)
    tab, t_emit, t_abst = _get_tab(smooth, mode, n, valid, chunk_batches,
                                   alpha, slack, gap_target)
    valid = valid[:n_batches]          # the padding batches are not run
    rows = []
    for i in range(g):
        z, x = smooth._inputs(zs[i], xs[i])
        rows.append(_run_core(
            smooth, z, x, labels[i], generators[i], valid0, valid,
            chunk_batches, n_chunks, t_emit, t_abst,
            None if noise0 is None else noise0[i],
            None if noise is None else noise[i]))
    rows = torch.stack(rows).cpu().numpy()          # one read for G ids
    return [_result_from_row(smooth, tab, mode, n0, n, n_chunks, alpha, row)
            for row in rows]


def certify_adaptive_device(smooth, z, x, label: int, n0: int, n: int,
                            alpha: float, generator, mode: str,
                            chunk_batches: int, slack: float, gap_target,
                            noise0=None, noise=None):
    """Engine="device" backend of Smooth.certify_adaptive: the same noise
    as the host engine, the stopping rules as thresholds on the device,
    the host engine's (prediction, gap, n_used) rebuilt from the row."""
    return certify_adaptive_device_many(
        smooth, [z], [x], [label], n0, n, alpha, [generator], mode,
        chunk_batches, slack, gap_target, noise0=None if noise0 is None
        else [noise0], noise=None if noise is None else [noise])[0]
