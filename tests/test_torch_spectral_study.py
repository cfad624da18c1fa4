"""The port's PSD-matched proxy weights (stylegan spectral_gamma) and
tools/spectral_study against the JAX package's, on the CPU:

* random_torch_style_state_dict(128, seed, realistic, spectral_gamma):
  every array bit-equal to the JAX package's for gamma in {0, 1.5, -1},
  and gamma = 0 equal to the call without gamma;
* radial_psd_slope on the same numpy images (white noise, a 1/f^2 field,
  a synthesized batch): equal to the JAX package's within 1e-12;
* measure_gamma at 64^2, f32, 4 images, gamma in {0, -1}: the slope within
  1e-3 of the JAX package's;
* the port's direction test at 128^2 (as tests/test_spectral.py asserts
  it for the JAX package): gamma = 2 steepens the slope by more than 0.7,
  gamma = -1 flattens it by more than 0.3.

Torch runs one intra-op thread per process: the suite runs in several
pytest-xdist workers that share the machine's cores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.models import stylegan as jsg
from certifyingfacerecognition_tpu.tools import spectral_study as jss
from certifyingfacerecognition_torch.models import stylegan as tsg
from certifyingfacerecognition_torch.tools import spectral_study as tss

torch.set_num_threads(1)


@pytest.mark.parametrize("realistic", [False, True])
@pytest.mark.parametrize("gamma", [0.0, 1.5, -1.0])
def test_spectral_gamma_weights_equal_jax(gamma, realistic):
    want = jsg.random_torch_style_state_dict(128, 3, realistic,
                                             spectral_gamma=gamma)
    got = tsg.random_torch_style_state_dict(128, 3, realistic,
                                            spectral_gamma=gamma)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if gamma == 0.0:
        plain = tsg.random_torch_style_state_dict(128, 3, realistic)
        for k in plain:
            np.testing.assert_array_equal(got[k], plain[k], err_msg=k)


def _images(kind):
    rng = np.random.default_rng(0)
    H = 64
    white = rng.standard_normal((4, H, H)).astype(np.float32)
    if kind == "white":
        return white
    if kind == "pink":
        f = np.sqrt(np.fft.fftfreq(H)[:, None] ** 2 +
                    np.fft.fftfreq(H)[None, :] ** 2)
        f[0, 0] = 1.0
        return np.real(np.fft.ifft2(np.fft.fft2(white) / (f * H))).astype(
            np.float32)
    params = tsg.random_params(H, seed=0, realistic=True, device="cpu")
    with torch.inference_mode():
        w = tsg.mapping_apply(params, torch.as_tensor(
            rng.standard_normal((4, 512)), dtype=torch.float32))
        img = tsg.synthesize_from_w(params, w, resolution=H)
    return img.permute(0, 2, 3, 1).numpy()          # [B, H, W, 3]


@pytest.mark.parametrize("kind", ["white", "pink", "synthesized"])
def test_radial_psd_slope_equal_jax(kind):
    x = _images(kind)
    got, (gf, gp) = tss.radial_psd_slope(x)
    want, (wf, wp) = jss.radial_psd_slope(x)
    assert abs(got - want) <= 1e-12
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_allclose(gp, wp, rtol=1e-12)
    if kind == "white":
        assert abs(got) < 0.4
    if kind == "pink":
        assert abs(got + 2.0) < 0.4


@pytest.mark.parametrize("gamma", [0.0, -1.0])
def test_measure_gamma_equal_jax(gamma):
    want = jss.measure_gamma(gamma, 64, n_images=4, dtype=jnp.float32)
    got = tss.measure_gamma(gamma, 64, n_images=4, dtype=torch.float32,
                            device="cpu")
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-3, (got, want)


def test_gamma_shapes_synthesized_spectrum_both_directions():
    slope = {g: tss.measure_gamma(g, 128, n_images=4, dtype=torch.float32,
                                  device="cpu") for g in (0.0, 2.0, -1.0)}
    assert slope[2.0] < slope[0.0] - 0.7, slope
    assert slope[-1.0] > slope[0.0] + 0.3, slope
