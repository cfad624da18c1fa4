"""Randomized-smoothing certifier (port of
certifyingfacerecognition_tpu/smoothing/smooth.py): the fixed-N estimator
and the early-stopping (adaptive) one.

Each MC batch draws noise on the device, perturbs the attribute vector,
runs the base classifier and adds its per-class counts into a counts
vector that stays on the device; the host reads the counts once per
``_sample_noise``. Every batch runs at the full batch size: the last one
of a budget that is not a multiple of it counts only its first
``n_valid`` samples. N0 selection, the Clopper-Pearson bound and the
pABar < 0.5 abstention follow the reference.

Noise discipline: every estimator draws, from the identity's generator and
in this order, the N0 batches, then the N batches one by one; the adaptive
ones only stop drawing earlier. Noise injection: ``certify``, ``predict``
and the adaptive estimators take optional precomputed noise arrays
[n_batches, batch_size, noise_dim] (already scaled by sigma), used in
place of the generator's draws, so that a test can feed the JAX package's
noise (the two frameworks draw different random streams).

Spans (utils/profiling.span): ``certify.batch`` over each MC batch, and
inside it ``certify.noise`` (the draw and x + noise) and
``certify.counts`` (the count and the mesh's all-reduce);
``certify.read`` over each host read of the counts.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .certificate import L2Certificate
from ..utils.device import resolve_device
from ..utils.profiling import span
from ..utils.stats import binom_two_sided_pvalue, clopper_pearson_lower

ABSTAIN = -1


def identity_generator(seed: int, index: int, device, stream: int = None
                       ) -> torch.Generator:
    """The generator of identity ``index`` in a run seeded with ``seed``:
    streams of different identities are independent and each is
    reproducible on its own (resume, job arrays). ``stream`` derives
    another independent generator of the same identity (the cascade's fast
    pass)."""
    entropy = [seed, index] + ([] if stream is None else [stream])
    state = np.random.SeedSequence(entropy).generate_state(2)
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def batch_valid(num: int, batch_size: int) -> np.ndarray:
    """Valid samples of each MC batch of a ``num``-sample budget: full
    batches, the last one ragged."""
    valid = np.full((math.ceil(num / batch_size),), batch_size, np.int64)
    valid[-1] = num - (len(valid) - 1) * batch_size
    return valid


def _make_batch_fn(predict_fn: Callable, num_classes: int,
                   certificate: L2Certificate, batch_size: int,
                   noise_dim: int, device, with_params: bool = False,
                   mesh=None) -> Callable:
    """One MC batch -> per-class counts [num_classes] (f32, on device).
    Signature: (params, z, x, sigma, generator, n_valid, noise=None).

    With a ``mesh`` (parallel/mesh.Mesh), mc rank m classifies samples
    [m B / n_mc, (m + 1) B / n_mc) of the batch and the counts are summed
    over the mesh's mc_group, so every rank returns the whole batch's
    counts. Each rank draws the whole batch's noise from the generator
    (B x k floats) and keeps its slice, so the samples, and the results,
    do not depend on the number of ranks. (The JAX package folds each
    device's key by its axis index, so its mesh results depend on the
    mesh shape; the port's noise stream differs from JAX's in any case.)"""
    lo, n_local = 0, batch_size
    if mesh is not None:
        if batch_size % mesh.n_mc:
            raise ValueError(f"--batch-sz {batch_size} is not a multiple of "
                             f"the {mesh.n_mc} mc ranks")
        n_local = batch_size // mesh.n_mc
        lo = mesh.mc * n_local
    positions = torch.arange(lo, lo + n_local, device=device)

    def batch_counts(params, z, x, sigma, generator, n_valid, noise=None):
        with span("certify.batch", outer=True):
            with span("certify.noise"):
                if noise is None:
                    noise = certificate.sample_noise(
                        generator, (batch_size, noise_dim), sigma)
                else:
                    noise = torch.as_tensor(noise, dtype=torch.float32,
                                            device=device)
                p = x[None, :] + noise[lo:lo + n_local]
            preds = predict_fn(params, z, p) if with_params \
                else predict_fn(z, p)
            with span("certify.counts"):
                weights = (positions < n_valid).float()
                counts = torch.zeros((num_classes,), dtype=torch.float32,
                                     device=device).index_add_(0, preds,
                                                               weights)
                if mesh is not None:
                    dist.all_reduce(counts, group=mesh.mc_group)
            return counts

    return batch_counts


class Smooth:
    """A smoothed classifier g.

    Args:
      predict_fn: (z [512], p [B, k]) -> class predictions [B], or
        (params, z, p) when ``params`` is given.
      num_classes: gallery size.
      sigma: scalar or [k] noise scale (anisotropic diagonal).
      certificate: the L2Certificate.
      noise_dim: k.
      batch_size: device batch of the MC loop.
      device: where noise, counts and the classifier run (default cuda).
      mesh: optional parallel/mesh.Mesh: each MC batch is split over its
        mc ranks and the counts summed over them (``_make_batch_fn``);
        every rank then takes the same decisions.
    """

    ABSTAIN = ABSTAIN

    def __init__(self, predict_fn: Callable, num_classes: int, sigma,
                 certificate: L2Certificate, noise_dim: int,
                 batch_size: int = 100, params=None, device="cuda",
                 mesh=None):
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.sigma = torch.as_tensor(np.asarray(sigma, np.float32),
                                     device=self.device)
        self.certificate = certificate
        self.batch_size = batch_size
        self.noise_dim = noise_dim
        self.params = params
        self._batch_fn = _make_batch_fn(
            predict_fn, num_classes, certificate, batch_size, noise_dim,
            self.device, with_params=params is not None, mesh=mesh)
        # threshold tables of the device engine (adaptive_device.py), with
        # their device copies, keyed by the full rule config
        self._adaptive_tab_cache = {}

    def _inputs(self, z, x):
        """(z, x) as f32 tensors on the device."""
        return (torch.as_tensor(np.array(z, np.float32), device=self.device),
                torch.as_tensor(np.asarray(x, np.float32), device=self.device))

    def _counts(self, z, x, valid, generator: torch.Generator,
                noise=None) -> torch.Tensor:
        """Per-class counts, on the device, of one MC batch per entry of
        ``valid`` (its valid samples). ``noise``: optional injected noise,
        one batch per entry."""
        counts = torch.zeros((self.num_classes,), dtype=torch.float32,
                             device=self.device)
        for i, n_valid in enumerate(valid):
            counts += self._batch_fn(
                self.params, z, x, self.sigma, generator, int(n_valid),
                None if noise is None else noise[i])
        return counts

    def _sample_noise(self, z, x, num: int, generator: torch.Generator,
                      noise=None) -> np.ndarray:
        """Per-class counts from ``num`` noisy forwards. ``noise``: optional
        [ceil(num / batch_size), batch_size, noise_dim] injected noise."""
        z, x = self._inputs(z, x)
        counts = self._counts(z, x, batch_valid(num, self.batch_size),
                              generator, noise)
        with span("certify.read"):
            return counts.cpu().numpy()

    def certify(self, z, x, label: int, n0: int, n: int, alpha: float,
                generator: torch.Generator, noise0=None, noise=None):
        """Certify g's prediction around (z, x). Returns (prediction, gap);
        (ABSTAIN, 0.0) on abstention. ``noise0``/``noise``: optional
        injected noise of the selection and estimation phases."""
        counts0 = self._sample_noise(z, x, n0, generator, noise0)
        c_a_hat = int(counts0.argmax())
        if c_a_hat != int(label):
            return c_a_hat, 0.0
        counts = self._sample_noise(z, x, n, generator, noise)
        n_a = int(counts[c_a_hat])
        p_a_bar = clopper_pearson_lower(n_a, n, alpha)
        if p_a_bar < 0.5:
            return ABSTAIN, 0.0
        return c_a_hat, self.certificate.compute_gap(p_a_bar)

    def predict(self, z, x, n: int, alpha: float,
                generator: torch.Generator, noise=None) -> int:
        """Monte-Carlo prediction with the two-sided binomial abstention
        test."""
        counts = self._sample_noise(z, x, n, generator, noise)
        top2 = counts.argsort()[::-1][:2]
        c1, c2 = int(counts[top2[0]]), int(counts[top2[1]])
        if binom_two_sided_pvalue(c1, c1 + c2, 0.5) > alpha:
            return ABSTAIN
        return int(top2[0])

    def certify_adaptive(self, z, x, label: int, n0: int, n: int,
                         alpha: float, generator: torch.Generator,
                         mode: str = "guaranteed", chunk_batches: int = 8,
                         slack: float = 0.1, gap_target=None,
                         engine: str = "host", noise0=None, noise=None):
        """Early-stopping certification. Returns (prediction, gap, n_used).

        Draws the same noise as ``certify`` (the N0 batches, then the N
        batches in order) and looks at the running success count every
        ``chunk_batches`` batches; it stops when the outcome is settled:

        ``mode="guaranteed"``: deterministic futility bounds. At m of N
        samples with n_a successes, the full run's Clopper-Pearson bound
        lies between CP(n_a, N) and CP(n_a + N - m, N). Above 0.5 at the
        lower end the full run certifies (emit the lower end, a valid gap
        never above the full run's, once it is within ``slack`` of the
        upper end); below 0.5 at the upper end it abstains. Decisions equal
        the fixed-N run's for the same noise; with slack 0 the gaps do too.
        ``gap_target`` g0 also stops as soon as "certified at gap >= g0" is
        settled either way.

        ``mode="sequential"``: alpha-spending checkpoints (alpha/2 for the
        last look, alpha/(2(K-1)) for each of the K-1 early ones): stops as
        soon as the checkpoint's own bound CP(n_a, m, alpha_k) clears 0.5
        (within ``slack`` of the best still reachable gap, or at
        ``gap_target``) or its upper bound falls below 0.5. Decisions agree
        with the fixed-N run only statistically; coverage holds at alpha.

        N0 selection is unchanged in both. ``engine="host"`` reads n_a once
        per checkpoint and evaluates the rules on the host;
        ``engine="device"`` (adaptive_device.py) keeps n_a, m and the status
        on the device, compares n_a with precomputed integer thresholds and
        reads one status per checkpoint. Both return the same tuple except
        in guaranteed mode with ``gap_target``, where the device engine may
        stop later with a larger, still valid gap. ``noise0``/``noise``:
        optional injected noise of the two phases."""
        from ..utils.stats import clopper_pearson_upper

        assert mode in ("guaranteed", "sequential"), mode
        assert engine in ("host", "device"), engine
        if engine == "device":
            from .adaptive_device import certify_adaptive_device
            return certify_adaptive_device(
                self, z, x, label, n0, n, alpha, generator, mode=mode,
                chunk_batches=chunk_batches, slack=slack,
                gap_target=gap_target, noise0=noise0, noise=noise)
        z, x = self._inputs(z, x)
        bs = self.batch_size
        counts0 = self._counts(z, x, batch_valid(n0, bs), generator, noise0)
        with span("certify.read"):
            c_a_hat = int(counts0.argmax())
        if c_a_hat != int(label):
            return c_a_hat, 0.0, n0

        valid = batch_valid(n, bs)
        n_chunks = math.ceil(len(valid) / chunk_batches)
        alpha_early = alpha / (2 * (n_chunks - 1)) if n_chunks > 1 else alpha
        alpha_final = alpha / 2 if n_chunks > 1 else alpha
        n_a, m = 0, 0
        for c in range(n_chunks):
            sl = slice(c * chunk_batches, (c + 1) * chunk_batches)
            counts = self._counts(z, x, valid[sl], generator,
                                  None if noise is None else noise[sl])
            with span("certify.read"):
                n_a += int(counts[c_a_hat])            # one read
            m += int(valid[sl].sum())
            last = c == n_chunks - 1

            if mode == "guaranteed":
                lb_lo = clopper_pearson_lower(n_a, n, alpha)
                lb_hi = clopper_pearson_lower(n_a + (n - m), n, alpha)
                if lb_hi < 0.5:
                    return ABSTAIN, 0.0, n0 + m       # full run must abstain
                if lb_lo >= 0.5:                      # full run must certify
                    gap_lo = self.certificate.compute_gap(lb_lo)
                    gap_hi = self.certificate.compute_gap(lb_hi)
                    if gap_target is not None and (gap_lo >= gap_target
                                                   or gap_hi < gap_target):
                        return c_a_hat, gap_lo, n0 + m
                    if last or gap_lo >= (1.0 - slack) * gap_hi:
                        return c_a_hat, gap_lo, n0 + m
                if last:                              # unsettled: exact N run
                    if lb_lo < 0.5:
                        return ABSTAIN, 0.0, n0 + m
            else:
                a_k = alpha_final if last else alpha_early
                lb_k = clopper_pearson_lower(n_a, m, a_k)
                if clopper_pearson_upper(n_a, m, a_k) < 0.5:
                    return ABSTAIN, 0.0, n0 + m
                if lb_k >= 0.5:
                    gap_k = self.certificate.compute_gap(lb_k)
                    if gap_target is not None and gap_k >= gap_target:
                        return c_a_hat, gap_k, n0 + m
                    gap_best = self.certificate.compute_gap(
                        clopper_pearson_lower(n_a + (n - m), n, alpha_final))
                    if last or gap_k >= (1.0 - slack) * gap_best:
                        return c_a_hat, gap_k, n0 + m
                if last:
                    return ABSTAIN, 0.0, n0 + m
        raise AssertionError("unreachable")  # pragma: no cover

    def certify_adaptive_many(self, zs, xs, labels, n0: int, n: int,
                              alpha: float, generators,
                              mode: str = "guaranteed",
                              chunk_batches: int = 8, slack: float = 0.1,
                              gap_target=None, pad_to: int = 0,
                              noise0=None, noise=None):
        """Grouped device engine: G identities, each with its own generator
        (and optional injected noise, one array per identity) and its own
        early exit, one result read for the group. Each identity's
        (prediction, gap, n_used) equals ``certify_adaptive(...,
        engine="device")``'s with the same generator. ``pad_to`` is the
        JAX package's compile-shape bucket; eager PyTorch compiles nothing,
        so it has no effect."""
        assert mode in ("guaranteed", "sequential"), mode
        from .adaptive_device import certify_adaptive_device_many
        return certify_adaptive_device_many(
            self, zs, xs, labels, n0, n, alpha, generators, mode=mode,
            chunk_batches=chunk_batches, slack=slack,
            gap_target=gap_target, pad_to=pad_to, noise0=noise0, noise=noise)
