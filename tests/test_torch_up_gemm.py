"""The bf16 up kernel's deconvolution as the kernel decomposes it, emulated
in f32 on the CPU: ``pack_up_weights`` read back through the
``mma.m16n8k16`` B-fragment map, and the kernel's tile, parity-class and
staged-pixel index map (csrc/synthesis_tail_bc.cu, ``deconv_mma``),
against ``F.conv_transpose2d`` as ``_up_t`` calls it, the JAX package's
``models/stylegan._upconv``, and ``_up_t``'s blur.

Tolerance: 1e-5 of the largest reference value (f32; only the order of the
f32 sums differs). The out-of-grid border of the haloed grid must be
exactly 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from certifyingfacerecognition_tpu.models.stylegan import _upconv
from certifyingfacerecognition_torch.ops import synthesis_tail_bc as tbc

UT = 8            # output tile edge of the kernel
SHAPES = [(16, 16), (32, 16), (64, 32)]
REL = 1e-5


def _fragment_index(cc_n, s_n):
    """(k, n) of every entry of packed[kh, kw] by the B-fragment map of
    mma.m16n8k16 (.col): lane 4g + t holds B[k, g] at k = 2t, 2t + 1 in its
    first register and 2t + 8, 2t + 9 in its second."""
    cc, s, lane, q = np.meshgrid(np.arange(cc_n), np.arange(s_n),
                                 np.arange(32), np.arange(4), indexing="ij")
    g, t = lane // 4, lane % 4
    k = 16 * s + 2 * t + (q % 2) + 8 * (q // 2)
    return k.ravel(), (8 * cc + g).ravel()


def _tap_weights(packed):
    """{(kh, kw): [Ci, Co] f32} read from the packed weights."""
    cc_n, s_n = packed.shape[2], packed.shape[3]
    k, n = _fragment_index(cc_n, s_n)
    out = {}
    for kh in range(4):
        for kw in range(4):
            w = torch.full((16 * s_n, 8 * cc_n), float("nan"))
            w[k, n] = packed[kh, kw].reshape(-1).float()
            out[kh, kw] = w
    return out


def _emulate_deconv(xa, packed, h, w):
    """The kernel's deconvolution of xa [H, W, Ci, B] (input affine already
    applied): per 8x8 output tile, the 6x6 input region staged with 0
    outside the image; per output parity class (pr, pc), the 5x5 outputs of
    the tile's 10x10 halo with that parity, each the sum over its 2x2 taps
    of W_tap^T @ staged pixel. Returns the haloed grid [2H+2, 2W+2, Co, B]
    (entry [orow + 1, ocol + 1]), 0 outside the 2H x 2W grid; where tile
    halos overlap, both tiles must give the same values."""
    ci, b = xa.shape[2], xa.shape[3]
    taps = _tap_weights(packed)
    co = taps[0, 0].shape[1]
    oh, ow = 2 * h, 2 * w
    ntr, ntc = -(-oh // UT), -(-ow // UT)
    y = torch.full((ntr * UT + 2, ntc * UT + 2, co, b), float("nan"))
    for r0 in range(0, ntr * UT, UT):
        for q0 in range(0, ntc * UT, UT):
            stage = torch.zeros((6, 6, ci, b))
            for sy in range(6):
                for sx in range(6):
                    m, n = r0 // 2 - 1 + sy, q0 // 2 - 1 + sx
                    if 0 <= m < h and 0 <= n < w:
                        stage[sy, sx] = xa[m, n]
            tile = torch.zeros((UT + 2, UT + 2, co, b))
            for pr in range(2):
                for pc in range(2):
                    for u in range(5):
                        for v in range(5):
                            i, j = 2 * u + 1 - pr, 2 * v + 1 - pc
                            orow, ocol = r0 - 1 + i, q0 - 1 + j
                            assert (orow & 1, ocol & 1) == (pr, pc)
                            if not (0 <= orow < oh and 0 <= ocol < ow):
                                continue
                            acc = torch.zeros((co, b))
                            for a in range(2):
                                for e in range(2):
                                    kh, kw = pr + 2 * a, pc + 2 * e
                                    # the kernel's map: input row
                                    # m = (orow + kh - 2) / 2 is staged row
                                    # u + a (columns alike)
                                    assert (orow + kh) % 2 == 0
                                    assert (orow + kh - 2) // 2 == \
                                        r0 // 2 - 1 + u + a
                                    assert (ocol + kw - 2) // 2 == \
                                        q0 // 2 - 1 + v + e
                                    acc += taps[kh, kw].t() @ stage[u + a,
                                                                    v + e]
                            tile[i, j] = acc
            region = y[r0:r0 + UT + 2, q0:q0 + UT + 2]
            seen = ~torch.isnan(region)
            assert torch.equal(region[seen], tile[seen])
            y[r0:r0 + UT + 2, q0:q0 + UT + 2] = tile
    return y[:oh + 2, :ow + 2]


def _inputs(ci, co, h, seed):
    rng = np.random.default_rng(seed)
    b = 3
    x = rng.standard_normal((h, h, ci, b)).astype(np.float32)
    k4 = (rng.standard_normal((4, 4, ci, co)) * 0.2).astype(np.float32)
    # bf16-exact weights, as the kernel wrappers hand them over
    k4 = torch.tensor(k4).bfloat16().float()
    nb = torch.tensor(rng.standard_normal((2 * h, 2 * h, co)),
                      dtype=torch.float32)
    aff = torch.tensor(np.stack([
        rng.standard_normal((ci, b)) * 0.3 + 1.0,
        rng.standard_normal((ci, b))]), dtype=torch.float32)
    return torch.tensor(x), k4, nb, aff


def _assert_close(got, want):
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= REL * scale


@pytest.mark.parametrize("ci,co", SHAPES)
def test_pack_up_weights_follows_the_fragment_map(ci, co):
    _, k4, _, _ = _inputs(ci, co, 2, seed=0)
    packed = tbc.pack_up_weights(k4)
    assert packed.dtype == torch.bfloat16
    assert packed.shape == (4, 4, co // 8, ci // 16, 32, 4)
    for (kh, kw), w in _tap_weights(packed).items():
        assert torch.equal(w, k4[kh, kw])


@pytest.mark.parametrize("h", [8, 5])
@pytest.mark.parametrize("ci,co", SHAPES)
def test_emulated_deconv_matches_conv_transpose_and_jax(ci, co, h):
    """The interior of the haloed grid is the transposed conv; its border
    (outputs -1 and 2H of the grid) is exactly 0."""
    x, k4, _, _ = _inputs(ci, co, h, seed=1)
    y = _emulate_deconv(x, tbc.pack_up_weights(k4), h, h)
    wt = torch.flip(k4, (0, 1)).permute(2, 3, 0, 1)
    want = F.conv_transpose2d(x.permute(3, 2, 0, 1), wt, stride=2,
                              padding=1).permute(2, 3, 1, 0)
    _assert_close(y[1:-1, 1:-1], want)
    want_jax = np.asarray(_upconv(jnp.asarray(x.permute(3, 0, 1, 2).numpy()),
                                  jnp.asarray(k4.numpy()), None))
    _assert_close(y[1:-1, 1:-1], torch.tensor(want_jax).permute(1, 2, 3, 0))
    border = torch.ones(y.shape[:2], dtype=torch.bool)
    border[1:-1, 1:-1] = False
    assert torch.equal(y[border], torch.zeros_like(y[border]))


@pytest.mark.parametrize("apply_aff", [False, True])
@pytest.mark.parametrize("h", [8, 5])
@pytest.mark.parametrize("ci,co", SHAPES)
def test_emulated_deconv_blurs_to_up_t(ci, co, h, apply_aff):
    """The blur read from the haloed grid (no padding of its own), then
    +nb and lrelu, is _up_t's t in f32; the input affine touches in-image
    pixels only (staged pixels outside the image stay 0, not aff(0))."""
    x, k4, nb, aff = _inputs(ci, co, h, seed=2)
    xa = x * aff[0] + aff[1] if apply_aff else x
    y = _emulate_deconv(xa, tbc.pack_up_weights(k4), h, h)
    v = (y[:-2] + y[2:]) * 0.25 + y[1:-1] * 0.5
    hb = (v[:, :-2] + v[:, 2:]) * 0.25 + v[:, 1:-1] * 0.5
    t = torch.where(hb + nb[..., None] >= 0, hb + nb[..., None],
                    0.2 * (hb + nb[..., None]))
    want = tbc._up_t(x, k4, nb, aff, apply_aff).permute(2, 3, 1, 0)
    _assert_close(t, want)


def test_pack_up_weights_refuses_ragged_channels():
    with pytest.raises(ValueError, match="multiple of 16"):
        tbc.pack_up_weights(torch.zeros((4, 4, 24, 16)))
    with pytest.raises(ValueError, match="multiple of 16"):
        tbc.pack_up_weights(torch.zeros((4, 4, 16, 12)))
