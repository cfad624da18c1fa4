"""The port's NN primitives (certifyingfacerecognition_torch.models.nn)
against the JAX package's (models/nn.py), on the CPU. Inputs come from a
seeded numpy RNG; the port is NCHW, the JAX package NHWC, so the JAX
results are transposed before comparing. f32 tolerance: rtol=atol=1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.models import nn as jnn
from certifyingfacerecognition_torch.models import nn as tnn

F32 = dict(rtol=1e-5, atol=1e-5)


def _nhwc(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _to_nchw(a):
    return np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))


def _t(a_nhwc, dtype=torch.float32):
    return torch.tensor(np.transpose(a_nhwc, (0, 3, 1, 2))).to(dtype)


@pytest.mark.parametrize("name", ["lrelu", "pixel_norm", "blur_3x3",
                                  "instance_norm", "prelu"])
def test_primitive_f32_matches_jax(name):
    x = _nhwc((2, 8, 8, 6))
    alpha = np.abs(_nhwc((6,), 1)) + 0.1
    if name == "prelu":
        want = jnn.prelu(jnp.asarray(x), jnp.asarray(alpha))
        got = tnn.prelu(_t(x), torch.tensor(alpha))
    elif name == "pixel_norm":   # over the channel axis: [B, C] input
        x2 = x.reshape(-1, 6)
        want = jnn.pixel_norm(jnp.asarray(x2))
        got = tnn.pixel_norm(torch.tensor(x2))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        return
    else:
        want = getattr(jnn, name)(jnp.asarray(x))
        got = getattr(tnn, name)(_t(x))
    np.testing.assert_allclose(got.numpy(), _to_nchw(want), **F32)


def test_instance_norm_bf16_matches_jax():
    """bf16: one-pass f32 moments, bf16 apply in both packages. The two
    round the apply's subtraction and product to bf16 at the same points;
    stated tolerance 1 bf16 ulp of the output range (atol=rtol=1/64)."""
    x = _nhwc((2, 8, 8, 6), 3) * 3.0 + 1.0
    want = jnn.instance_norm(jnp.asarray(x, jnp.bfloat16))
    got = tnn.instance_norm(_t(x, torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), _to_nchw(want),
                               rtol=1 / 64, atol=1 / 64)


def test_nearest_up_conv3_tconv_kernel_matches_jax_and_op_pair():
    k3 = _nhwc((3, 3, 4, 5), 4)
    want = np.asarray(jnn.nearest_up_conv3_as_tconv_kernel(jnp.asarray(k3)))
    got = tnn.nearest_up_conv3_as_tconv_kernel(torch.tensor(k3))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    # the rewrite equals upsample + conv3x3 (the f32 path's literal pair)
    x = _t(_nhwc((2, 6, 6, 4), 5))
    pair = tnn.conv2d(tnn.upsample_nearest_2x(x), torch.tensor(k3))
    np.testing.assert_allclose(tnn.upconv(x, got).numpy(), pair.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_upconv_matches_jax_lhs_dilated_conv():
    from certifyingfacerecognition_tpu.models.stylegan import _upconv

    x = _nhwc((2, 5, 7, 4), 6)
    k4 = _nhwc((4, 4, 4, 3), 7)
    want = _upconv(jnp.asarray(x), jnp.asarray(k4), jnn.precision_for(
        jnp.float32))
    got = tnn.upconv(_t(x), torch.tensor(k4))
    np.testing.assert_allclose(got.numpy(), _to_nchw(want), **F32)


def test_conv2d_hwio_and_weight_helpers_match_jax():
    x = _nhwc((2, 9, 9, 4), 8)
    k = _nhwc((3, 3, 4, 6), 9)
    for stride in (1, 2):
        want = jnn.conv2d(jnp.asarray(x), jnp.asarray(k), stride=stride,
                          precision=jnn.precision_for(jnp.float32))
        got = tnn.conv2d(_t(x), torch.tensor(k), stride=stride)
        np.testing.assert_allclose(got.numpy(), _to_nchw(want), **F32)
    w = _nhwc((6, 4, 3, 3), 10)
    np.testing.assert_array_equal(tnn.torch_conv_to_hwio(w),
                                  jnn.torch_conv_to_hwio(w))
    lin = _nhwc((5, 7), 11)
    np.testing.assert_array_equal(tnn.torch_linear_to_io(lin),
                                  jnn.torch_linear_to_io(lin))
    g, b, m = _nhwc((4,), 12), _nhwc((4,), 13), _nhwc((4,), 14)
    v = np.abs(_nhwc((4,), 15)) + 0.5
    for got, want in zip(tnn.fold_batchnorm(g, b, m, v, 1e-5),
                         jnn.fold_batchnorm(g, b, m, v, 1e-5)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride,padding,ksize", [
    (1, 1, (3, 3)), (2, 0, (3, 3)), (1, ((0, 0), (3, 3)), (1, 7)),
    (1, ((3, 3), (0, 0)), (7, 1)), (2, ((1, 1), (1, 1)), (3, 3)),
    (1, ((0, 2), (1, 0)), (3, 3))],
    ids=["pad1", "s2-valid", "1x7", "7x1", "s2-same", "asymmetric"])
def test_conv2d_stride_and_padding_match_jax(stride, padding, ksize):
    """conv2d's stride and padding forms (an int, or per side ((top,
    bottom), (left, right)) as FaceNet's 1x7 / 7x1 and 1x3 / 3x1 convs use
    them) against the JAX conv2d."""
    x = _nhwc((2, 9, 10, 4))
    k = _nhwc(ksize + (4, 5), 1)
    jpad = ((padding, padding), (padding, padding)) \
        if isinstance(padding, int) else padding
    want = jnn.conv2d(jnp.asarray(x), jnp.asarray(k), stride=stride,
                      padding=jpad, precision=jnn.precision_for(jnp.float32))
    got = tnn.conv2d(_t(x), torch.tensor(k), padding=padding, stride=stride)
    np.testing.assert_allclose(got.numpy(), _to_nchw(want), **F32)


def test_max_pool_3x3_s2_matches_jax():
    from certifyingfacerecognition_tpu.models import facenet as jfn

    x = _nhwc((2, 11, 12, 3))
    want = jfn._max_pool_3x3_s2(jnp.asarray(x))
    np.testing.assert_array_equal(tnn.max_pool_3x3_s2(_t(x)).numpy(),
                                  _to_nchw(want))
