"""The L2 certificate for randomized smoothing (port of
certifyingfacerecognition_tpu/smoothing/certificate.py). Noise is drawn on
the device from an explicit torch.Generator; the certificate math runs on
the host. ``sigma`` may be a scalar or a per-attribute vector
(anisotropic diagonal Sigma)."""

from __future__ import annotations

import torch

from ..utils.stats import gaussian_quantile


class L2Certificate:
    """Gaussian smoothing; gap = Phi^{-1}(pABar)."""

    norm = "l2"

    def compute_proxy_gap(self, probs: torch.Tensor) -> torch.Tensor:
        """Phi^-1(p0) - Phi^-1(p1) of the first two columns of ``probs``
        [B, >= 2], each clipped to [0.001, 0.999]."""
        p0 = torch.clamp(probs[:, 0], 0.001, 0.999)
        p1 = torch.clamp(probs[:, 1], 0.001, 0.999)
        return torch.special.ndtri(p0) - torch.special.ndtri(p1)

    def sample_noise(self, generator: torch.Generator, shape, sigma
                     ) -> torch.Tensor:
        """N(0, sigma^2) noise of ``shape`` on the generator's device."""
        sigma = torch.as_tensor(sigma, dtype=torch.float32,
                                device=generator.device)
        return torch.randn(shape, generator=generator,
                           device=generator.device) * sigma

    def compute_gap(self, p_a_bar: float) -> float:
        return gaussian_quantile(p_a_bar)

    def compute_gap_vec(self, p_a_bar):
        """compute_gap over a numpy array in one scipy call
        (adaptive_device.build_thresholds evaluates it at every candidate
        success count)."""
        from scipy.stats import norm
        return norm.ppf(p_a_bar)

    def compute_radius_estimate(self, probs: torch.Tensor, sigma
                                ) -> torch.Tensor:
        return sigma / 2.0 * self.compute_proxy_gap(probs)
