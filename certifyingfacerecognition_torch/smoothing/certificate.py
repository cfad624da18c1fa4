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

    def sample_noise(self, generator: torch.Generator, shape, sigma
                     ) -> torch.Tensor:
        """N(0, sigma^2) noise of ``shape`` on the generator's device."""
        sigma = torch.as_tensor(sigma, dtype=torch.float32,
                                device=generator.device)
        return torch.randn(shape, generator=generator,
                           device=generator.device) * sigma

    def compute_gap(self, p_a_bar: float) -> float:
        return gaussian_quantile(p_a_bar)
