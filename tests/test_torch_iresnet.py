"""The port's ArcFace iresnet (certifyingfacerecognition_torch.models.
iresnet) against the JAX package's, same weights, f32 on the CPU.
Tolerance rtol=1e-4, atol=1e-4 x the embedding scale (f32 summation order
through 20-50 convolutions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.models import iresnet as jir
from certifyingfacerecognition_tpu.utils import weights as jw
from certifyingfacerecognition_torch.models import iresnet as tir
from certifyingfacerecognition_torch.utils import weights as tw


@pytest.mark.parametrize("arch,realistic", [("iresnet18", True),
                                            ("iresnet50", False)])
def test_iresnet_f32_matches_jax(arch, realistic):
    sd = jir.random_torch_style_state_dict(arch, seed=1, realistic=realistic)
    jp = jir.convert_torch_state_dict(sd, arch)
    tp = tw.params_from_jax(jw.flatten_params(jp), device="cpu")
    x = np.random.default_rng(2).standard_normal(
        (2, 112, 112, 3)).astype(np.float32)
    want = np.asarray(jir.apply(jp, jnp.asarray(x)))
    got = tir.apply(tp, torch.tensor(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
