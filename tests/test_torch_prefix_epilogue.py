"""The synthesis epilogue's kernel path (ops/prefix_epilogue.py) on the
CPU: its plain version (the formula in f32) against the port's plain-ops
``models/stylegan._epilogue`` and the JAX package's ``_epilogue``, both in
f32; which path ``_epilogue`` takes; and what the wrapper refuses. The
kernels themselves run only on the card
(tests/test_torch_prefix_epilogue_cuda.py).

Tolerance of the f32 comparisons: rtol = atol = 1e-5, on outputs up to
about 15 in size. The plain version adds noise * noise_weight + bias to x
as one f32 value (nb), where ``_epilogue`` adds the two terms one after the
other, and it scales by rsqrt(var + eps) and s0 + 1 in another order: a few
f32 roundings of t, amplified by rsqrt(var) (about 1 here); measured at
most 4.8e-6 against either."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.models import nn as jnn
from certifyingfacerecognition_tpu.models import stylegan as jsg
from certifyingfacerecognition_torch.models import stylegan as tsg
from certifyingfacerecognition_torch.ops import prefix_epilogue as pe

torch.set_num_threads(1)
F32 = dict(rtol=1e-5, atol=1e-5)
CL = torch.channels_last


def _layer(c, h, b, seed=0):
    """A layer's epilogue parameters (f32 numpy, the JAX package's
    layouts), an NHWC activation and w_layer, all from one seed."""
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"noise": randn(h, h, c), "noise_weight": randn(c, scale=0.3),
         "bias": randn(c, scale=0.3), "style_weight": randn(512, 2 * c),
         "style_bias": randn(2 * c, scale=0.3)}
    return p, randn(b, h, h, c), randn(b, 512)


def _nchw(a):
    return torch.tensor(np.transpose(a, (0, 3, 1, 2))).contiguous()


def _torch_layer(p):
    return {k: torch.tensor(v) for k, v in p.items()}


@pytest.mark.parametrize("c,h,b", [(8, 4, 3), (16, 8, 2), (4, 16, 1),
                                   (6, 32, 2)])
def test_plain_version_matches_epilogue_and_jax_f32(c, h, b):
    p, x, w = _layer(c, h, b)
    tp, xt, wt = _torch_layer(p), _nchw(x), torch.tensor(w)
    got = pe.prefix_epilogue_ref(xt, pe.nb_of(tp),
                                 tsg._style_dense(tp, wt, dtype=torch.float32))
    want_port = tsg._epilogue(tp, xt, wt, dtype=torch.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want_jax = jsg._epilogue(jp, jnp.asarray(x), jnp.asarray(w),
                             dtype=jnp.float32,
                             prec=jnn.precision_for(jnp.float32))
    np.testing.assert_allclose(got.numpy(), want_port.numpy(), **F32)
    np.testing.assert_allclose(
        got.numpy(), np.transpose(np.asarray(want_jax), (0, 3, 1, 2)), **F32)


def test_wrapper_on_the_cpu_is_the_plain_version_in_bf16():
    p, x, w = _layer(8, 16, 2, seed=2)
    tp, wt = _torch_layer(p), torch.tensor(w).to(torch.bfloat16)
    xt = _nchw(x).to(torch.bfloat16).contiguous(memory_format=CL)
    args = (pe.nb_of(tp).to(torch.bfloat16),
            tsg._style_dense(tp, wt, dtype=torch.bfloat16))
    pe.reset_launches()
    got = pe.prefix_epilogue(xt, *args)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=CL)
    assert torch.equal(got, pe.prefix_epilogue_ref(xt, *args))
    assert pe.LAUNCHES == {"prefix_epilogue": 0, "prefix_epilogue_plain": 0}


@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16_grad", "f32_grad"])
def test_epilogue_on_the_cpu_takes_the_plain_ops(mode):
    """On the CPU every call is today's plain ops, bit for bit, and neither
    counter moves (the CUDA cases: the card test)."""
    dtype = torch.float32 if mode.startswith("f32") else torch.bfloat16
    p, x, w = _layer(8, 8, 2, seed=3)
    tp = {k: v.to(dtype) for k, v in _torch_layer(p).items()}
    xt, wt = _nchw(x).to(dtype), torch.tensor(w).to(dtype)
    if mode.endswith("grad"):
        wt.requires_grad_(True)
    pe.reset_launches()
    got = tsg._epilogue(tp, xt, wt, dtype=dtype)
    assert pe.LAUNCHES == {"prefix_epilogue": 0, "prefix_epilogue_plain": 0}
    assert got.requires_grad == mode.endswith("grad")
    assert torch.equal(got, tsg._epilogue_plain(tp, xt, wt, dtype=dtype))


@pytest.mark.parametrize("case,kernel", [
    ("bf16", True), ("f32", False), ("f16", False), ("bf16_w_grad", False),
    ("bf16_x_grad", False), ("bf16_style_weight_grad", False),
    ("bf16_w_grad_no_grad_mode", True), ("bf16_512", False),
    ("bf16_256", True), ("bf16_c12", False), ("bf16_c24", False),
    ("bf16_c4096", False), ("bf16_tiny", False)])
def test_which_epilogues_take_the_kernel(case, kernel):
    """The choice _epilogue makes for a tensor on the card, from its dtype,
    shape and grad mode (the device check precedes it)."""
    h = int(case.split("_")[1]) if case[-3:].isdigit() and "_c" not in case \
        else 8
    c = int(case.split("_c")[1]) if "_c" in case else 32
    if case.endswith("tiny"):      # c h w < 2048
        c, h = 8, 4
    dtype = {"bf": torch.bfloat16, "f3": torch.float32,
             "f1": torch.float16}[case[:2]]
    p, _, w = _layer(c, 8, 2, seed=4)
    tp = _torch_layer(p)
    xt = torch.zeros((2, c, h, h), dtype=dtype)
    wt = torch.tensor(w).to(dtype)
    if "w_grad" in case:
        wt.requires_grad_(True)
    if "x_grad" in case:
        xt.requires_grad_(True)
    if "style_weight_grad" in case:
        tp["style_weight"].requires_grad_(True)
    with torch.set_grad_enabled("no_grad_mode" not in case):
        assert tsg._takes_kernel(tp, xt, wt) == kernel


def _args(b=2, c=16, h=16):
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    return (torch.randn((b, c, h, h), generator=g).to(bf).contiguous(
                memory_format=CL),
            torch.randn((h, h, c), generator=g).to(bf),
            torch.randn((b, 2 * c), generator=g).to(bf))


@pytest.mark.parametrize("case", ["x_requires_grad", "style_requires_grad",
                                  "x_f32", "x_f16", "nb_f32", "style_f32",
                                  "x_plane_contiguous", "x_strided",
                                  "channels_12", "channels_24", "nb_shape",
                                  "style_shape", "plane_6x6",
                                  "plane_512x512"])
def test_wrapper_raises(case):
    x, nb, style = _args()
    err = ValueError
    if case == "x_requires_grad":
        x = x.float().requires_grad_(True).to(torch.bfloat16)
        assert x.is_contiguous(memory_format=CL)
        err = RuntimeError
    elif case == "style_requires_grad":
        style.requires_grad_(True)
        err = RuntimeError
    elif case == "x_f32":
        x = x.float()
    elif case == "x_f16":
        x = x.half()
    elif case == "nb_f32":
        nb = nb.float()
    elif case == "style_f32":
        style = style.float()
    elif case == "x_plane_contiguous":
        x = x.contiguous()
    elif case == "x_strided":
        x = x[:, :, ::2, ::2]
        nb = nb[::2, ::2].contiguous()
    elif case.startswith("channels_"):
        x, nb, style = _args(c=int(case.split("_")[1]))
    elif case == "nb_shape":
        nb = nb[:4]
    elif case == "style_shape":
        style = style[:, :16]
    elif case == "plane_6x6":
        x = x[:, :, :6, :6].contiguous(memory_format=CL)
        nb = nb[:6, :6].contiguous()
    elif case == "plane_512x512":
        x, nb, style = _args(b=1, h=512)
    with pytest.raises(err):
        pe.prefix_epilogue(x, nb, style)


def test_wrapper_takes_requires_grad_inputs_under_no_grad():
    x, nb, style = _args()
    style.requires_grad_(True)
    with torch.no_grad():
        out = pe.prefix_epilogue(x, nb, style)
    assert torch.equal(out, pe.prefix_epilogue_ref(x, nb, style.detach()))
