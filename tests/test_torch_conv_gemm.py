"""The bf16 conv kernel's 3x3 convolution as the kernel decomposes it,
emulated in f32 on the CPU: ``pack_mma_weights`` read back through the
``mma.m16n8k16`` B-fragment map, and the kernel's tile, halo, staged-pixel
and input-channel-chunk index map (csrc/synthesis_tail_bc.cu, ``conv_tc``
and ``conv_mma``), against ``F.conv2d`` as ``_conv_t`` calls it and the JAX
package's ``models/nn.conv2d``; then the epilogue (+nb, lrelu) against
``_conv_t`` and the per-thread, per-tile fixed-point sums against
``_sums``.

Tolerance: 1e-5 of the largest reference value (f32; only the order of the
f32 sums differs). Staged pixels outside the image must be exactly 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from certifyingfacerecognition_tpu.models import nn as jnn
from certifyingfacerecognition_torch.ops import synthesis_tail_bc as tbc

CT = 8            # output tile edge of the kernel
CR = CT + 2       # staged input region edge
CC = 8            # output channels per pass (one n8 tile)
WIDTH = 11        # image width: two tile columns, the second one ragged
# (Ci = Co, staging chunk ck): ck = Ci stages the whole region once per
# tile; ck < Ci restages it chunk by chunk for every pass (on an H100 the
# kernel takes ck = 16 for MODE_T at Ci = 64 and 128, ck = 32 for
# MODE_APPLY at Ci = 64)
CHUNKS = [(16, 16), (32, 32), (64, 16), (64, 32), (128, 16)]
CASES = [(c, ck, h) for c, ck in CHUNKS for h in (8, 5)
         if c < 128 or h == 5]
REL = 1e-5
SUM_UNIT = 2.0 ** -20


def _fragment_index(cc_n, s_n):
    """(k, n) of every entry of packed[dy, dx] by the B-fragment map of
    mma.m16n8k16 (.col): lane 4g + t holds B[k, g] at k = 2t, 2t + 1 in its
    first register and 2t + 8, 2t + 9 in its second."""
    cc, s, lane, q = np.meshgrid(np.arange(cc_n), np.arange(s_n),
                                 np.arange(32), np.arange(4), indexing="ij")
    g, t = lane // 4, lane % 4
    k = 16 * s + 2 * t + (q % 2) + 8 * (q // 2)
    return k.ravel(), (8 * cc + g).ravel()


def _tap_weights(packed):
    """{(dy, dx): [Ci, Co] f32} read from the packed weights; an entry no
    fragment holds stays NaN."""
    kh, kw, cc_n, s_n = packed.shape[:4]
    k, n = _fragment_index(cc_n, s_n)
    out = {}
    for dy in range(kh):
        for dx in range(kw):
            w = torch.full((16 * s_n, 8 * cc_n), float("nan"))
            w[k, n] = packed[dy, dx].reshape(-1).float()
            out[dy, dx] = w
    return out


def _stage(x, aff, r0, q0, ci0, ck):
    """The kernel's staged region of one tile and chunk: [CR, CR, ck, B],
    the input affine on in-image pixels only, 0 outside the image."""
    h, w = x.shape[:2]
    stage = torch.zeros((CR, CR, ck, x.shape[3]))
    for sy in range(CR):
        for sx in range(CR):
            m, n = r0 - 1 + sy, q0 - 1 + sx
            if 0 <= m < h and 0 <= n < w:
                v = x[m, n, ci0:ci0 + ck]
                if aff is not None:
                    v = v * aff[0, ci0:ci0 + ck] + aff[1, ci0:ci0 + ck]
                stage[sy, sx] = v
    return stage


def _emulate_conv(x, aff, packed, ck):
    """The kernel's conv of x [H, W, Ci, B] (input affine ``aff`` or None):
    per CT x CT output tile, per pass of CC output channels, per chunk of
    ck input channels (k16 steps ci0/16 ..) the staged region, then per
    warp row pair pg (the m16 sample tiles split the samples, which the
    emulation takes at once), kernel row dy, output row r and staged
    column sx, the outputs j = sx - dx of the three taps (dy, dx) that read
    staged pixel (2pg + r + dy, sx). Returns (y [H, W, Co, B], the list of
    (tile origin, warp row pair, its 16 outputs' y [2, CT, Co, B] with
    NaN outside the image)) for the sums."""
    h, w, ci, b = x.shape
    taps = _tap_weights(packed)
    co = taps[0, 0].shape[1]
    y = torch.full((h, w, co, b), float("nan"))
    warps = []
    for r0 in range(0, h, CT):
        for q0 in range(0, w, CT):
            acc = torch.zeros((4, 2, CT, co, b))
            for c0 in range(0, co, CC):
                for ci0 in range(0, ci, ck):
                    stage = _stage(x, aff, r0, q0, ci0, ck)
                    for pg in range(4):
                        for dy in range(3):
                            wt = [taps[dy, dx][ci0:ci0 + ck, c0:c0 + CC].t()
                                  for dx in range(3)]
                            for r in range(2):
                                for sx in range(CR):
                                    a = stage[2 * pg + r + dy, sx]
                                    for dx in range(3):
                                        j = sx - dx
                                        if 0 <= j < CT:
                                            acc[pg, r, j, c0:c0 + CC] += \
                                                wt[dx] @ a
            for pg in range(4):
                out = torch.full((2, CT, co, b), float("nan"))
                for r in range(2):
                    for j in range(CT):
                        oh, ow = r0 + 2 * pg + r, q0 + j
                        if oh < h and ow < w:
                            # each output is written by one tile only
                            assert torch.isnan(y[oh, ow]).all()
                            y[oh, ow] = out[r, j] = acc[pg, r, j]
                warps.append(((r0, q0), pg, out))
    assert not torch.isnan(y).any()
    return y, warps


def _inputs(c, h, seed, b=3):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((h, WIDTH, c, b)),
                     dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((3, 3, c, c)),
                     dtype=torch.float32) * (2.0 / (9 * c)) ** 0.5
    k = k.bfloat16().float()       # bf16-exact, as the wrappers pack them
    nb = torch.tensor(rng.standard_normal((h, WIDTH, c)) * 0.1,
                      dtype=torch.float32)
    aff = torch.tensor(np.stack([rng.standard_normal((c, b)) * 0.3 + 1.0,
                                 rng.standard_normal((c, b))]),
                       dtype=torch.float32)
    return x, k, nb, aff


def _assert_close(got, want, rel=REL):
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= rel * scale


@pytest.mark.parametrize("ci,co", [(16, 16), (32, 32), (64, 64), (128, 128),
                                   (32, 16)])
def test_pack_mma_weights_follows_the_fragment_map(ci, co):
    _, k, _, _ = _inputs(ci, 1, seed=0)
    k = k[..., :co]
    packed = tbc.pack_mma_weights(k)
    assert packed.dtype == torch.bfloat16
    assert packed.shape == (3, 3, co // 8, ci // 16, 32, 4)
    for (dy, dx), w in _tap_weights(packed).items():
        assert torch.equal(w, k[dy, dx])


def test_pack_mma_weights_refuses_ragged_channels():
    with pytest.raises(ValueError, match="multiple of 16"):
        tbc.pack_mma_weights(torch.zeros((3, 3, 24, 16)))
    with pytest.raises(ValueError, match="multiple of 16"):
        tbc.pack_mma_weights(torch.zeros((3, 3, 16, 12)))


@pytest.mark.parametrize("apply_aff", [False, True])
@pytest.mark.parametrize("c,ck,h", CASES)
def test_emulated_conv_matches_conv2d_and_jax(c, ck, h, apply_aff):
    """The emulated conv is F.conv2d of aff(x) with zero padding (so the
    staged border is 0, not aff(0)) and the JAX nn.conv2d."""
    x, k, _, aff = _inputs(c, h, seed=1)
    y, _ = _emulate_conv(x, aff if apply_aff else None,
                         tbc.pack_mma_weights(k), ck)
    xa = x * aff[0] + aff[1] if apply_aff else x
    want = F.conv2d(xa.permute(3, 2, 0, 1), k.permute(3, 2, 0, 1),
                    padding=1).permute(2, 3, 1, 0)
    _assert_close(y, want)
    want_jax = jnn.conv2d(jnp.asarray(xa.permute(3, 0, 1, 2).numpy()),
                          jnp.asarray(k.numpy()),
                          precision=jax.lax.Precision.HIGHEST)
    _assert_close(y, torch.tensor(np.asarray(want_jax)).permute(1, 2, 3, 0))


@pytest.mark.parametrize("apply_aff", [False, True])
@pytest.mark.parametrize("c,ck,h", [(16, 16, 5), (32, 32, 8), (64, 16, 5)])
def test_emulated_epilogue_and_sums_match_conv_t(c, ck, h, apply_aff):
    """+nb and lrelu on the emulated conv is _conv_t's t; each warp's f32
    sums over its 16 outputs of a tile, added in 2^-20 fixed point over
    the tiles, are _sums(t) (in-image outputs only)."""
    x, k, nb, aff = _inputs(c, h, seed=2)
    y, warps = _emulate_conv(x, aff if apply_aff else None,
                             tbc.pack_mma_weights(k), ck)
    t = y + nb[..., None]
    t = torch.where(t >= 0, t, 0.2 * t)
    want = tbc._conv_t(x, k, nb, aff, apply_aff)
    _assert_close(t, want.permute(2, 3, 1, 0))

    # nb padded to whole tiles (the padding meets only NaN outputs)
    nbp = torch.zeros((-(-h // CT) * CT, -(-WIDTH // CT) * CT, c))
    nbp[:h, :WIDTH] = nb
    fixed = torch.zeros((2, c, x.shape[3]), dtype=torch.int64)
    for (r0, q0), pg, yw in warps:
        tw = yw + nbp[r0 + 2 * pg:r0 + 2 * pg + 2, q0:q0 + CT, :, None]
        tw = torch.where(tw >= 0, tw, 0.2 * tw)
        live = ~torch.isnan(tw)
        for which, v in enumerate((tw, tw * tw)):
            s = torch.where(live, v, torch.zeros_like(v)).sum((0, 1))
            fixed[which] += torch.round(s / SUM_UNIT).long()
    got = fixed.double() * SUM_UNIT
    want_sums = tbc._sums(want).double()
    for row in range(2):
        _assert_close(got[row], want_sums[row])
