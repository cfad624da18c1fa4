"""The hand-written CUDA kernels of the synthesis tail (the chain kernels
and the standalone half-layer passes) against their plain PyTorch
versions, on the GPU. Marked ``cuda``; without a CUDA device
every test skips (there is no CPU mode of a CUDA kernel). Run on a
machine with the card: ``python -m pytest --noconftest
tests/test_torch_kernels_cuda.py -m cuda`` (tests/conftest.py imports JAX,
which these tests do not need).

Tolerance: max |kernel - plain| <= 2^-6 x max |plain| in bf16 (two bf16
ulps at the top of the range: an intermediate that differs in its last
f32 bit can round the other way), 1e-4 x in f32; each row of the f32 sums
(sum t, sum t^2) to 1e-4 x its own largest value (the kernels sum in
another order than the plain version, in 2^-20 fixed point). Two launches
on the same inputs give the same bits."""

import pytest
import torch

from certifyingfacerecognition_torch.ops import synthesis_tail_bc as bc

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-4}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(shape, gen, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


def _close(got, want, rel):
    got, want = got.float(), want.float()
    assert (got - want).abs().max().item() <= rel * want.abs().max().item()


def _sums_close(got, want):
    """[2, Co, B] sums: sum t and sum t^2 each against its own scale."""
    for row in range(2):
        _close(got[row], want[row], 1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("apply_aff", [False, True])
@pytest.mark.parametrize("h,ci,co,b", [(8, 16, 16, 8), (16, 32, 16, 40)])
def test_kernels_match_plain(gen, dtype, apply_aff, h, ci, co, b):
    x = _randn((h, h, ci, b), gen).to(dtype)
    aff = torch.stack([_randn((ci, b), gen, 0.3) + 1, _randn((ci, b), gen)])
    k4, nb = _randn((4, 4, ci, co), gen, 0.2), _randn((2 * h, 2 * h, co), gen)
    before = dict(bc.LAUNCHES)
    t, s = bc.up_fused(x, k4, nb, aff, apply_aff=apply_aff)
    tr, sr = bc.up_fused_ref(x, k4, nb, aff, apply_aff=apply_aff)
    _close(t, tr, TOL[dtype])
    _sums_close(s, sr)

    k, nbc = _randn((3, 3, co, co), gen, 0.2), _randn((2 * h, 2 * h, co), gen)
    aff2 = torch.stack([_randn((co, b), gen, 0.3) + 1, _randn((co, b), gen)])
    t2, s2 = bc.conv_fused(t, k, nbc, aff2, apply_aff=apply_aff)
    t2r, s2r = bc.conv_fused_ref(t, k, nbc, aff2, apply_aff=apply_aff)
    _close(t2, t2r, TOL[dtype])
    _sums_close(s2, s2r)
    _sums_close(bc.final_stats(t, k, nbc, aff2, apply_aff=apply_aff),
                bc.final_stats_ref(t, k, nbc, aff2, apply_aff=apply_aff))

    coefs = torch.stack([_randn((co, b), gen, 0.3) + 1, _randn((co, b), gen)])
    w_rgb, b_rgb = _randn((co, 3), gen, 0.3), _randn((3,), gen)
    _close(bc.final_apply(t, k, nbc, aff2, coefs, w_rgb, b_rgb,
                          apply_aff=apply_aff),
           bc.final_apply_ref(t, k, nbc, aff2, coefs, w_rgb, b_rgb,
                              apply_aff=apply_aff), TOL[dtype])
    assert all(bc.LAUNCHES[n] == before[n] + 1 for n in (
        "up_fused", "conv_fused", "final_stats", "final_apply"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,ci,co,b", [(8, 16, 16, 8), (16, 32, 16, 40)])
def test_standalone_kernels_match_plain(gen, dtype, h, ci, co, b):
    """The five passes of the standalone half-layers (no input affine,
    the layer's own affine applied by the producer)."""
    x = _randn((h, h, ci, b), gen).to(dtype)
    k4, nb2 = _randn((4, 4, ci, co), gen, 0.2), _randn((2 * h, 2 * h, co), gen)
    k, nb = _randn((3, 3, ci, co), gen, 0.2), _randn((h, h, co), gen)
    coefs = torch.stack([_randn((co, b), gen, 0.3) + 1, _randn((co, b), gen)])
    w_rgb, b_rgb = _randn((co, 3), gen, 0.3), _randn((3,), gen)
    names = ("conv_stats", "conv_apply", "conv_rgb_apply", "up_stats",
             "up_apply")
    before = dict(bc.LAUNCHES)
    _sums_close(bc.up_stats(x, k4, nb2), bc.up_stats_ref(x, k4, nb2))
    _close(bc.up_apply(x, k4, nb2, coefs), bc.up_apply_ref(x, k4, nb2, coefs),
           TOL[dtype])
    _sums_close(bc.conv_stats(x, k, nb), bc.conv_stats_ref(x, k, nb))
    _close(bc.conv_apply(x, k, nb, coefs), bc.conv_apply_ref(x, k, nb, coefs),
           TOL[dtype])
    _close(bc.conv_rgb_apply(x, k, nb, coefs, w_rgb, b_rgb),
           bc.conv_rgb_apply_ref(x, k, nb, coefs, w_rgb, b_rgb), TOL[dtype])
    assert all(bc.LAUNCHES[n] == before[n] + 1 for n in names)


def _small_grid_sums_close(got, want, t, dtype):
    """Sums over a small grid (10x10 outputs here): each row to 1e-4 x its
    own largest value, plus one output's tolerance of t (TOL x max |t| for
    sum t, and 2 max |t| times that for sum t^2). The kernel's t may take
    the other rounding at an output (a deconv value rounded to bf16 the
    other way moves the outputs its blur reaches by under a bf16 ulp in
    all), and on 100 pixels one such output is about 1e-4 of a row's
    largest sum (measured on an H100: 5.3e-3 of 34.5)."""
    tmax = t.float().abs().max().item()
    slack = (TOL[dtype] * tmax, 2 * tmax * TOL[dtype] * tmax)
    for row in range(2):
        err = (got[row] - want[row]).abs().max().item()
        assert err <= 1e-4 * want[row].abs().max().item() + slack[row]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ci,co,b", [(64, 32, 40), (128, 64, 40),
                                     (64, 32, 12)])
def test_up_kernels_match_plain_ragged(gen, dtype, ci, co, b):
    """The three up-kernel entry points at the tail's widths and at
    CFR_TAIL_MIN_RES=256's (Ci = 128), with ragged tiles (H = 5: a 10x10
    output grid in 8x8 tiles) and a ragged sample group (B = 40; B = 12
    also takes the bf16 kernel's unaligned staging path)."""
    h = 5
    x = _randn((h, h, ci, b), gen).to(dtype)
    aff = torch.stack([_randn((ci, b), gen, 0.3) + 1, _randn((ci, b), gen)])
    k4 = _randn((4, 4, ci, co), gen, (2.0 / (9 * ci)) ** 0.5)
    nb = _randn((2 * h, 2 * h, co), gen, 0.1)
    coefs = torch.stack([_randn((co, b), gen, 0.3) + 1, _randn((co, b), gen)])
    before = dict(bc.LAUNCHES)
    for apply_aff in (True, False):
        t, s = bc.up_fused(x, k4, nb, aff, apply_aff=apply_aff)
        tr, sr = bc.up_fused_ref(x, k4, nb, aff, apply_aff=apply_aff)
        _close(t, tr, TOL[dtype])
        _small_grid_sums_close(s, sr, tr, dtype)
    # tr: the plain t without the input affine, as up_stats computes it
    _small_grid_sums_close(bc.up_stats(x, k4, nb), bc.up_stats_ref(x, k4, nb),
                           tr, dtype)
    _close(bc.up_apply(x, k4, nb, coefs), bc.up_apply_ref(x, k4, nb, coefs),
           TOL[dtype])
    assert bc.LAUNCHES["up_fused"] == before["up_fused"] + 2
    assert all(bc.LAUNCHES[n] == before[n] + 1
               for n in ("up_stats", "up_apply"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [40, 12])
@pytest.mark.parametrize("c", [16, 32, 64, 128])
def test_conv_kernels_match_plain_ragged(gen, dtype, c, b):
    """The six conv-kernel entry points at Ci = Co = c, with ragged tiles
    (H = 5: one 8x8 tile, 5x5 of it in the image), a ragged sample group
    (B = 40; B = 12 also takes the bf16 kernel's unaligned staging path),
    the bf16 kernel's input staged whole (c <= 32) or in chunks (64, 128),
    and the ToRGB's channel sum over several passes (c > 16)."""
    h = 5
    x = _randn((h, h, c, b), gen).to(dtype)
    aff = torch.stack([_randn((c, b), gen, 0.3) + 1, _randn((c, b), gen)])
    k = _randn((3, 3, c, c), gen, (2.0 / (9 * c)) ** 0.5)
    nb = _randn((h, h, c), gen, 0.1)
    coefs = torch.stack([_randn((c, b), gen, 0.3) + 1, _randn((c, b), gen)])
    w_rgb, b_rgb = _randn((c, 3), gen, c ** -0.5), _randn((3,), gen, 0.1)
    names = ("conv_fused", "final_stats", "final_apply", "conv_stats",
             "conv_apply", "conv_rgb_apply")
    before = dict(bc.LAUNCHES)
    for apply_aff in (True, False):
        t, s = bc.conv_fused(x, k, nb, aff, apply_aff=apply_aff)
        tr, sr = bc.conv_fused_ref(x, k, nb, aff, apply_aff=apply_aff)
        _close(t, tr, TOL[dtype])
        _sums_close(s, sr)
        _sums_close(bc.final_stats(x, k, nb, aff, apply_aff=apply_aff),
                    bc.final_stats_ref(x, k, nb, aff, apply_aff=apply_aff))
        _close(bc.final_apply(x, k, nb, aff, coefs, w_rgb, b_rgb,
                              apply_aff=apply_aff),
               bc.final_apply_ref(x, k, nb, aff, coefs, w_rgb, b_rgb,
                                  apply_aff=apply_aff), TOL[dtype])
    _sums_close(bc.conv_stats(x, k, nb), bc.conv_stats_ref(x, k, nb))
    _close(bc.conv_apply(x, k, nb, coefs), bc.conv_apply_ref(x, k, nb, coefs),
           TOL[dtype])
    _close(bc.conv_rgb_apply(x, k, nb, coefs, w_rgb, b_rgb),
           bc.conv_rgb_apply_ref(x, k, nb, coefs, w_rgb, b_rgb), TOL[dtype])
    assert all(bc.LAUNCHES[n] == before[n] + (2 if n in names[:3] else 1)
               for n in names)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("apply_aff", [False, True])
def test_final_kernels_match_plain_at_512(gen, dtype, apply_aff):
    """final_stats and final_apply at 512^2 32 -> 32, the last layer of a
    512^2 synthesis (the cascade's fast pass)."""
    h, c, b = 512, 32, 8
    x = _randn((h, h, c, b), gen).to(dtype)
    aff = torch.stack([_randn((c, b), gen, 0.3) + 1, _randn((c, b), gen)])
    k, nb = _randn((3, 3, c, c), gen, (2.0 / (9 * c)) ** 0.5), \
        _randn((h, h, c), gen, 0.1)
    coefs = torch.stack([_randn((c, b), gen, 0.3) + 1, _randn((c, b), gen)])
    w_rgb, b_rgb = _randn((c, 3), gen, c ** -0.5), _randn((3,), gen)
    before = dict(bc.LAUNCHES)
    _sums_close(bc.final_stats(x, k, nb, aff, apply_aff=apply_aff),
                bc.final_stats_ref(x, k, nb, aff, apply_aff=apply_aff))
    _close(bc.final_apply(x, k, nb, aff, coefs, w_rgb, b_rgb,
                          apply_aff=apply_aff),
           bc.final_apply_ref(x, k, nb, aff, coefs, w_rgb, b_rgb,
                              apply_aff=apply_aff), TOL[dtype])
    assert all(bc.LAUNCHES[n] == before[n] + 1
               for n in ("final_stats", "final_apply"))


@pytest.mark.parametrize("h,ci,co", [(16, 32, 16), (5, 64, 32)])
def test_kernels_are_deterministic(gen, h, ci, co):
    """The fixed-point sums do not depend on the order of the atomic adds,
    the bf16 kernels' tensor-core convolutions and sums run in a fixed
    order per thread, and the bf16 ToRGB sums over a quad's lanes in a
    fixed order, so a second launch on the same inputs gives the same bits
    (also at ragged tiles, h = 5)."""
    b = 40
    x = _randn((h, h, ci, b), gen).to(torch.bfloat16)
    aff = torch.stack([_randn((ci, b), gen, 0.3) + 1, _randn((ci, b), gen)])
    aff2 = torch.stack([_randn((co, b), gen, 0.3) + 1, _randn((co, b), gen)])
    k4, nb = _randn((4, 4, ci, co), gen, 0.2), _randn((2 * h, 2 * h, co), gen)
    k, nbc = _randn((3, 3, co, co), gen, 0.2), _randn((2 * h, 2 * h, co), gen)
    coefs = torch.stack([_randn((co, b), gen, 0.3) + 1, _randn((co, b), gen)])
    w_rgb, b_rgb = _randn((co, 3), gen, 0.3), _randn((3,), gen)

    def run():
        t, s = bc.up_fused(x, k4, nb, aff)
        return (t, s, *bc.conv_fused(t, k, nbc, aff2),
                bc.up_stats(x, k4, nb), bc.conv_stats(t, k, nbc),
                bc.final_apply(t, k, nbc, aff2, coefs, w_rgb, b_rgb),
                bc.conv_rgb_apply(t, k, nbc, coefs, w_rgb, b_rgb))

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


def test_differentiable_ops_launch_kernels_and_match_refs(gen):
    """The standalone ops and the chain differentiate on the card: the
    forward launches the kernels, the backward is the plain reference's
    vjp (f32, to 1e-4 of each gradient's scale)."""
    b, h = 8, 8
    x = _randn((h, h, 16, b), gen).requires_grad_()
    k4, nb2 = _randn((4, 4, 16, 16), gen, 0.2), _randn((16, 16, 16), gen)
    s0 = (_randn((b, 16), gen, 0.2) + 1).requires_grad_()
    s1 = _randn((b, 16), gen, 0.2).requires_grad_()
    cot = _randn((2 * h, 2 * h, 16, b), gen)
    before = bc.LAUNCHES["up_apply"]
    out = bc.upconv_blur_epilogue_bc(x, k4, nb2, s0, s1)
    assert bc.LAUNCHES["up_apply"] == before + 1
    got = torch.autograd.grad((out * cot).sum(), (x, s0, s1))
    want = torch.autograd.grad((bc._upconv_ref(x, k4, nb2, s0, s1, 1e-8)
                                * cot).sum(), (x, s0, s1))
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_wrapper_raises_on_what_the_kernel_does_not_take(gen):
    with pytest.raises(RuntimeError, match="requires grad"):
        bc.conv_stats(_randn((8, 8, 16, 8), gen).requires_grad_(),
                      _randn((3, 3, 16, 16), gen), _randn((8, 8, 16), gen))
    x = _randn((8, 8, 16, 8), gen)
    aff = torch.stack([torch.ones((16, 8), device="cuda"),
                       torch.zeros((16, 8), device="cuda")])
    with pytest.raises(ValueError, match="multiple of 8"):
        bc.up_fused(x, _randn((4, 4, 16, 12), gen),
                    _randn((16, 16, 12), gen), aff)
    with pytest.raises(ValueError, match="multiple of 16"):
        bc.conv_fused(x, _randn((3, 3, 16, 8), gen),
                      _randn((8, 8, 8), gen), aff)
    # the bf16 up kernel's k16 steps need Ci a multiple of 16
    x24 = _randn((8, 8, 24, 8), gen).bfloat16()
    aff24 = torch.stack([torch.ones((24, 8), device="cuda"),
                         torch.zeros((24, 8), device="cuda")])
    for call in (lambda k, nb: bc.up_stats(x24, k, nb),
                 lambda k, nb: bc.up_apply(x24, k, nb, aff[:, :8]),
                 lambda k, nb: bc.up_fused(x24, k, nb, aff24)):
        with pytest.raises(ValueError, match="multiple of 16"):
            call(_randn((4, 4, 24, 8), gen), _randn((16, 16, 8), gen))
    # and so do the bf16 conv kernels'
    k24, nb24 = _randn((3, 3, 24, 16), gen), _randn((8, 8, 16), gen)
    coefs = torch.stack([torch.ones((16, 8), device="cuda"),
                         torch.zeros((16, 8), device="cuda")])
    w_rgb, b_rgb = _randn((16, 3), gen), _randn((3,), gen)
    for call in (lambda: bc.conv_fused(x24, k24, nb24, aff24),
                 lambda: bc.final_stats(x24, k24, nb24, aff24),
                 lambda: bc.final_apply(x24, k24, nb24, aff24, coefs, w_rgb,
                                        b_rgb),
                 lambda: bc.conv_stats(x24, k24, nb24),
                 lambda: bc.conv_apply(x24, k24, nb24, coefs),
                 lambda: bc.conv_rgb_apply(x24, k24, nb24, coefs, w_rgb,
                                           b_rgb)):
        with pytest.raises(ValueError, match="multiple of 16"):
            call()
    with pytest.raises(ValueError, match="contiguous"):
        bc.conv_fused(x.transpose(0, 1), _randn((3, 3, 16, 16), gen),
                      _randn((8, 8, 16), gen), aff)
    with pytest.raises(ValueError, match="dtype"):
        bc.conv_fused(x.half(), _randn((3, 3, 16, 16), gen),
                      _randn((8, 8, 16), gen), aff)
