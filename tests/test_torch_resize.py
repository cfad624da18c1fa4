"""The port's bilinear resize (certifyingfacerecognition_torch.ops.resize)
against the JAX package's and against torch's own F.interpolate, f32 on
the CPU, tolerance rtol=atol=1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from certifyingfacerecognition_tpu.ops import resize as jrs
from certifyingfacerecognition_torch.ops import resize as trs

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("out_size,in_size", [(112, 1024), (112, 128),
                                              (160, 256), (112, 32)])
def test_interp_matrix_equals_jax(out_size, in_size):
    np.testing.assert_array_equal(trs._interp_matrix(out_size, in_size),
                                  jrs._interp_matrix(out_size, in_size))


def test_transform_for_frs_matches_jax_and_interpolate():
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jrs.transform_for_frs(jnp.asarray(x), 112))
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    got = trs.transform_for_frs(xt, 112)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    ref = (F.interpolate(xt, size=(112, 112), mode="bilinear",
                         align_corners=False) - 0.5) / 0.5
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_transform_for_frs_cb_matches_jax():
    x = np.random.default_rng(1).uniform(0, 1, (3, 128, 128, 4)).astype(
        np.float32)
    want = np.asarray(jrs.transform_for_frs_cb(jnp.asarray(x), 112))
    got = trs.transform_for_frs_cb(torch.tensor(x), 112)
    assert got.shape == (4, 3, 112, 112)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
