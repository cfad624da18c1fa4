"""The synthesis epilogue's CUDA kernels (csrc/prefix_epilogue.cu) on the
card, at every shape of the 1024^2 synthesis up to 256^2 (4^2-32^2 x 512,
64^2 x 256, 128^2 x 128, 256^2 x 64) and B = 100 (the certify batch), 20
and 1. Marked ``cuda``; without a CUDA device every test skips (a CUDA
kernel has no CPU mode). Run on a machine with the card:
``python -m pytest --noconftest tests/test_torch_prefix_epilogue_cuda.py -m
cuda``.

The yardstick of error is the f32 epilogue (``_epilogue`` on f32 inputs
holding the bf16 activation's values): the kernels' max |error| must be no
larger than the plain bf16 ops' (``_epilogue`` with a graph to record),
and within one bf16 rounding of their own plain version (the same formula
in f32, rounded once: the two differ only in f32 summation order, which
can flip a rounding). Two calls on the same inputs give the same bits."""

import pytest
import torch

from certifyingfacerecognition_torch.models import stylegan
from certifyingfacerecognition_torch.ops import prefix_epilogue as pe

pytestmark = pytest.mark.cuda
SHAPES = [(4, 512), (8, 512), (16, 512), (32, 512), (64, 256), (128, 128),
          (256, 64)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _layer(gen, c, h, b):
    """A layer's f32 epilogue parameters, a bf16 activation (channels-last,
    as cuDNN leaves it) and w_layer."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    p = {"noise": randn(h, h, c), "noise_weight": randn(c, scale=0.3),
         "bias": randn(c, scale=0.3), "style_weight": randn(512, 2 * c),
         "style_bias": randn(2 * c, scale=0.3)}
    x = randn(b, c, h, h).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    return p, x, randn(b, 512)


@pytest.mark.parametrize("b", [100, 20, 1])
@pytest.mark.parametrize("h,c", SHAPES)
def test_kernel_against_f32_and_plain_bf16(gen, h, c, b):
    p, x, w = _layer(gen, c, h, b)
    bf = torch.bfloat16
    pe.reset_launches()
    truth = stylegan._epilogue(p, x.float(), w, dtype=torch.float32)
    with torch.enable_grad():
        plain = stylegan._epilogue(p, x, w.to(bf).requires_grad_(True),
                                   dtype=bf).detach()
    assert pe.LAUNCHES == {"prefix_epilogue": 0, "prefix_epilogue_plain": 2}
    with torch.no_grad():
        got = stylegan._epilogue(p, x, w.to(bf), dtype=bf)
        again = stylegan._epilogue(p, x, w.to(bf), dtype=bf)
    assert pe.LAUNCHES == {"prefix_epilogue": 2, "prefix_epilogue_plain": 2}
    assert got.dtype == bf and got.shape == x.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, again)

    err = (got.float() - truth).abs().max().item()
    err_plain = (plain.float() - truth).abs().max().item()
    assert err <= err_plain, (err, err_plain)

    ref = pe.prefix_epilogue_ref(
        x, pe.nb_of(p).to(bf),
        stylegan._style_dense(p, w.to(bf), dtype=bf)).float()
    assert ((got.float() - ref).abs()
            <= ref.abs() * 2.0 ** -7 + 1e-4 * ref.abs().max()).all()


def test_synthesis_takes_the_kernel_without_a_graph(gen, monkeypatch):
    """A 1024^2 bf16 synthesis through the chain tail: all 14 epilogues up
    to 256^2 take the kernel with no graph to record, none with one (and
    the backward's recompute of the 13 checkpointed ones takes the plain
    ops too)."""
    monkeypatch.setenv("CFR_TAIL", "bc")
    monkeypatch.delenv("CFR_TAIL_MIN_RES", raising=False)
    params = stylegan.random_params(1024, seed=0, device="cuda")
    w = torch.randn((2, 512), generator=gen, device="cuda")
    pe.reset_launches()
    with torch.no_grad():
        img = stylegan.synthesize_from_w(params, w, resolution=1024,
                                         dtype=torch.bfloat16)
    assert torch.isfinite(img).all()
    assert pe.LAUNCHES == {"prefix_epilogue": 14, "prefix_epilogue_plain": 0}

    pe.reset_launches()
    w.requires_grad_(True)
    img = stylegan.synthesize_from_w(params, w, resolution=1024,
                                     dtype=torch.bfloat16)
    assert pe.LAUNCHES == {"prefix_epilogue": 0, "prefix_epilogue_plain": 14}
    img.float().sum().backward()
    assert torch.isfinite(w.grad).all()
    assert pe.LAUNCHES == {"prefix_epilogue": 0, "prefix_epilogue_plain": 27}


def test_planes_above_256_take_the_plain_ops(gen):
    """A 512^2 plane (a synthesis without the chain tail) stays on the
    plain ops, and the wrapper refuses it."""
    p, x, w = _layer(gen, 8, 512, 2)
    pe.reset_launches()
    with torch.no_grad():
        got = stylegan._epilogue(p, x, w.to(torch.bfloat16),
                                 dtype=torch.bfloat16)
        want = stylegan._epilogue_plain(p, x, w.to(torch.bfloat16),
                                        dtype=torch.bfloat16)
    assert pe.LAUNCHES == {"prefix_epilogue": 0, "prefix_epilogue_plain": 1}
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        pe.prefix_epilogue(x, pe.nb_of(p).to(torch.bfloat16),
                           stylegan._style_dense(p, w.to(torch.bfloat16),
                                                 dtype=torch.bfloat16))
