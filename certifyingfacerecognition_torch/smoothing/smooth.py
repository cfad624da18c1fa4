"""Randomized-smoothing certifier with a fixed Monte-Carlo budget (port of
the fixed-N parts of certifyingfacerecognition_tpu/smoothing/smooth.py).

Each MC batch draws noise on the device, perturbs the attribute vector,
runs the base classifier and adds its per-class counts into a counts
vector that stays on the device; the host reads the counts once per
``_sample_noise``. Every batch runs at the full batch size: the last one
of a budget that is not a multiple of it counts only its first
``n_valid`` samples. N0 selection, the Clopper-Pearson bound and the
pABar < 0.5 abstention follow the reference.

Noise injection: ``certify``/``predict`` take optional precomputed noise
arrays [n_batches, batch_size, noise_dim] (already scaled by sigma), used
in place of the generator's draws, so that a test can feed the JAX
package's noise (the two frameworks draw different random streams).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from .certificate import L2Certificate
from ..utils.device import resolve_device
from ..utils.stats import binom_two_sided_pvalue, clopper_pearson_lower

ABSTAIN = -1


def identity_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of identity ``index`` in a run seeded with ``seed``:
    streams of different identities are independent and each is
    reproducible on its own (resume, job arrays)."""
    state = np.random.SeedSequence([seed, index]).generate_state(2)
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def _make_batch_fn(predict_fn: Callable, num_classes: int,
                   certificate: L2Certificate, batch_size: int,
                   noise_dim: int, device, with_params: bool = False
                   ) -> Callable:
    """One MC batch -> per-class counts [num_classes] (f32, on device).
    Signature: (params, z, x, sigma, generator, n_valid, noise=None)."""

    def batch_counts(params, z, x, sigma, generator, n_valid, noise=None):
        if noise is None:
            noise = certificate.sample_noise(
                generator, (batch_size, noise_dim), sigma)
        else:
            noise = torch.as_tensor(noise, dtype=torch.float32,
                                    device=device)
        p = x[None, :] + noise
        preds = predict_fn(params, z, p) if with_params else predict_fn(z, p)
        weights = (torch.arange(batch_size, device=device)
                   < n_valid).float()
        return torch.zeros((num_classes,), dtype=torch.float32,
                           device=device).index_add_(0, preds, weights)

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
    """

    ABSTAIN = ABSTAIN

    def __init__(self, predict_fn: Callable, num_classes: int, sigma,
                 certificate: L2Certificate, noise_dim: int,
                 batch_size: int = 100, params=None, device="cuda"):
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
            self.device, with_params=params is not None)

    def _sample_noise(self, z, x, num: int, generator: torch.Generator,
                      noise=None) -> np.ndarray:
        """Per-class counts from ``num`` noisy forwards. ``noise``: optional
        [ceil(num / batch_size), batch_size, noise_dim] injected noise."""
        n_batches = math.ceil(num / self.batch_size)
        z = torch.as_tensor(np.array(z, np.float32), device=self.device)
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        counts = torch.zeros((self.num_classes,), dtype=torch.float32,
                             device=self.device)
        for i in range(n_batches):
            n_valid = min(self.batch_size, num - i * self.batch_size)
            counts += self._batch_fn(
                self.params, z, x, self.sigma, generator, n_valid,
                None if noise is None else noise[i])
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
