"""The bf16 up kernel's deconvolution as the kernel decomposes it, emulated
in f32 on the CPU (csrc/synthesis_tail_bc.cu, ``up_wgmma_kernel``):

* ``pack_up_weights`` read back through the B operand's descriptor (K-major
  without swizzle: k8 chunks 128 B apart, n8 groups 256 B apart);
* the stages as TMA writes them (the box [2 input rows][5 columns][16
  channels][64 samples], 128-byte rows under the 128-byte swizzle) and the
  A operand read back through its descriptor (MN-major, 128-byte swizzle,
  k8 groups 1024 B apart), the ragged-B staging's addresses against them;
* the work units (64 samples x 16 output channels x a strip of 6 output
  columns x a chunk of output rows), each deconvolving rows r0 - 1 .. r1
  and columns q0 - 1 .. q0 + 6, zero outside the 2H x 2W grid, and the
  input affine applied in the stage to in-image pixels only;
* the consumer's ring of three deconvolved rows, blurred into output row
  d - 1 after row d,

against ``F.conv_transpose2d`` as ``_up_t`` calls it, the JAX package's
``models/stylegan._upconv``, and ``_up_t``'s blur.

Tolerance: 1e-5 of the largest reference value (f32; only the order of the
f32 sums differs). The out-of-grid border of the haloed grid must be
exactly 0, and where two units deconvolve the same output (the strips'
halo columns, the row chunks' halo rows) they must agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from certifyingfacerecognition_tpu.models.stylegan import _upconv
from certifyingfacerecognition_torch.ops import synthesis_tail_bc as tbc

# the kernel's constants (UM, UN, UW, UIC, UROWS)
UM, UN, UW, UIC, UROWS = 64, 16, 6, 5, 64
UDC = UW + 2
PIX = 16 * UM * 2          # bytes of one staged pixel (one k16 step)
IN_BYTES = 2 * UIC * PIX   # the input part of a stage
SHAPES = [(16, 16), (32, 16), (64, 32)]
REL = 1e-5


def _swizzle(off):
    """The 128-byte swizzle of a byte offset in a 1024-byte aligned buffer:
    the 16-byte chunk (bits 4-6) XOR the 128-byte row (bits 7-9)."""
    return off ^ (((off >> 7) & 7) << 4)


def _tma_stage(x, ma, n0, ci0, b0):
    """A stage's input as TMA writes it: the box [2][UIC][16][UM] of x
    [H, W, Ci, B] at rows ma, ma + 1, columns n0.., channels ci0..,
    samples b0.. (0 where the box runs past x), row-major, at swizzled
    byte offsets. Returns the stage as a flat array of bf16 slots."""
    h, w, _, b = x.shape
    box = np.zeros((2, UIC, 16, UM), np.float32)
    nbv = min(UM, b - b0)
    for a in range(2):
        for n in range(UIC):
            m, nn = ma + a, n0 + n
            if 0 <= m < h and 0 <= nn < w:
                box[a, n, :, :nbv] = x[m, nn, ci0:ci0 + 16, b0:b0 + nbv]
    flat = np.full(IN_BYTES // 2, np.nan, np.float32)
    flat[_swizzle(np.arange(box.size) * 2) // 2] = box.ravel()
    return flat


def _ragged_stage(x, ma, n0, ci0, b0, gran):
    """stage_ragged's copies: granules of `gran` samples of each 128-byte
    row R (input row R / 80, column (R / 16) % 5, channel R % 16), written
    at R * 128 + ((k / 8) ^ (R % 8)) * 16 + (k % 8) * 2 for the granule's
    first sample k, zero fill outside the image, samples >= B left at the
    0 the ring starts with."""
    h, w, _, b = x.shape
    flat = np.zeros(IN_BYTES // 2, np.float32)
    per_row = -(-min(UM, b - b0) // gran)
    for i in range(2 * UIC * 16 * per_row):
        r, k = i // per_row, (i % per_row) * gran
        m, nn = ma + r // (UIC * 16), n0 + (r >> 4) % UIC
        d = r * 128 + ((((k >> 3) ^ (r & 7)) << 4) | ((k & 7) * 2))
        for j in range(gran):
            if 0 <= m < h and 0 <= nn < w:
                flat[d // 2 + j] = x[m, nn, ci0 + (r & 15), b0 + k + j]
            else:
                flat[d // 2 + j] = 0.0
    return flat


def _affine_stage(flat, aff_s, ma, n0, ci0, h, w):
    """affine_stage: producer thread p takes the 16-byte chunk p % 8 of row
    p / 8 of every staged pixel k (bytes k * 2048 + p * 16): channel
    ci0 + p / 8, samples 8 lc .. 8 lc + 7 with lc = (p % 8) ^ (p / 8 % 8);
    times a plus off, in-image pixels only. aff_s [2, Ci, UM]."""
    out = flat.copy()
    for p in range(128):
        row = p >> 3
        ci, lc = ci0 + row, (p & 7) ^ (row & 7)
        a, o = aff_s[0, ci, 8 * lc:8 * lc + 8], aff_s[1, ci, 8 * lc:8 * lc + 8]
        for k in range(2 * UIC):
            m, nn = ma + k // UIC, n0 + k % UIC
            if 0 <= m < h and 0 <= nn < w:
                sl = slice((k * PIX + p * 16) // 2, (k * PIX + p * 16) // 2 + 8)
                out[sl] = flat[sl] * a + o
    return out


def _read_a(flat, start):
    """The A operand [UM samples, 16 channels] of the staged pixel at byte
    `start` through its descriptor: MN-major (the samples contiguous),
    128-byte swizzle, k8 row groups 1024 B apart (SBO)."""
    m, k = np.arange(UM)[:, None], np.arange(16)[None, :]
    off = start + (k // 8) * 1024 + (k % 8) * 128 + m * 2
    return flat[_swizzle(off) // 2]


def _read_b(wflat, start):
    """The B operand [16 input channels (K), 16 output channels (N)] of the
    tap at byte `start` of a 4 KB weight block through its descriptor:
    K-major without swizzle, core matrices of 8 N rows x 16 B, k8 chunks
    128 B apart (LBO), n8 groups 256 B apart (SBO)."""
    k, n = np.arange(16)[:, None], np.arange(16)[None, :]
    off = start + (n // 8) * 256 + (k // 8) * 128 + (n % 8) * 16 + (k % 8) * 2
    return wflat[off // 2]


def _units(h, w, b, co, rows):
    """(b0, c0, q0, r0, r1) of every block of a launch."""
    oh, ow = 2 * h, 2 * w
    return [(b0, c0, q0, r0, min(oh, r0 + rows))
            for b0 in range(0, b, UM) for c0 in range(0, co, UN)
            for q0 in range(0, ow, UW) for r0 in range(0, oh, rows)]


def _emulate(x, packed, co, aff=None, rows=UROWS, stage=_tma_stage):
    """The kernel's deconvolution of x [H, W, Ci, B] (f32, the affine aff
    [2, Ci, B] applied in the stage when given). Yields, per unit and
    deconvolved row d, (b0, c0, q0, d, D) with D [UDC, nbv, 16] the row's
    columns q0 - 1 .. q0 + UW (0 outside the grid), in the order the
    consumer produces them."""
    h, w, ci, b = x.shape
    pk = packed.float().numpy().reshape(packed.shape[0], 2, ci // 16, -1)
    for b0, c0, q0, r0, r1 in _units(h, w, b, co, rows):
        nbv, n0 = min(UM, b - b0), q0 // 2 - 1
        if aff is not None:
            aff_s = np.zeros((2, ci, UM), np.float32)
            aff_s[0] = 1.0
            aff_s[:, :, :nbv] = aff[:, :, b0:b0 + nbv]
        for d in range(r0 - 1, r1 + 1):
            pr = d & 1
            ma = (d + pr - 2) // 2
            assert (d + pr - 2) % 2 == 0
            acc = np.zeros((UDC, UM, UN), np.float64)
            for s in range(ci // 16):
                flat = stage(x, ma, n0, 16 * s, b0)
                if aff is not None:
                    flat = _affine_stage(flat, aff_s, ma, n0, 16 * s, h, w)
                wflat = pk[c0 // UN, pr, s]
                for i in range(UDC):
                    for a in range(2):
                        for e in range(2):
                            kw = ((i + 1) & 1) + 2 * e
                            # the kernel's map: output column q0 - 1 + i
                            # with tap kw reads input column n0 + i/2 + e
                            col = q0 - 1 + i
                            assert (col + kw - 2) // 2 == n0 + (i >> 1) + e
                            acc[i] += _read_a(
                                flat, (a * UIC + (i >> 1) + e) * PIX) @ \
                                _read_b(wflat, (a * 4 + kw) * 512)
            for i in range(UDC):
                if not (0 <= d < 2 * h and 0 <= q0 - 1 + i < 2 * w):
                    acc[i] = 0.0
            yield b0, c0, q0, d, acc[:, :nbv].astype(np.float32)


def _haloed_grid(x, packed, co, **kw):
    """The deconvolution as [2H + 2, 2W + 2, Co, B] (entry [d + 1, c + 1]);
    where units overlap, both must give the same values."""
    h, w, _, b = x.shape
    y = np.full((2 * h + 2, 2 * w + 2, co, b), np.nan, np.float32)
    for b0, c0, q0, d, dd in _emulate(x, packed, co, **kw):
        nbv, nco = dd.shape[1], min(UN, co - c0)
        vals = dd[:, :, :nco].transpose(0, 2, 1)      # [col, co, b]
        cols = slice(q0, q0 + UDC)
        region = y[d + 1, cols, c0:c0 + nco, b0:b0 + nbv]
        vals = vals[:region.shape[0]]
        seen = ~np.isnan(region)
        assert np.array_equal(region[seen], vals[seen])
        y[d + 1, cols, c0:c0 + nco, b0:b0 + nbv] = vals
    return torch.tensor(y)


def _blur(p, m, q):
    return (p + q) * 0.25 + m * 0.5


def _emulate_t(x, packed, nb, co, **kw):
    """t = lrelu(blur(deconv) + nb) [2H, 2W, Co, B], each unit's output row
    d - 1 blurred from its ring of rows d - 2, d - 1, d once row d is
    deconvolved (vertical, then horizontal across the UDC columns)."""
    h, w, _, b = x.shape
    t = torch.full((2 * h, 2 * w, co, b), float("nan"))
    ring = []
    for b0, c0, q0, d, dd in _emulate(x, packed, co, **kw):
        if ring and ring[-1][0] != (b0, c0, q0) or \
                ring and ring[-1][1] != d - 1:
            ring = []                       # a new unit starts its ring
        ring = (ring + [((b0, c0, q0), d, dd)])[-3:]
        if len(ring) < 3:
            continue
        d0, d1, d2 = (torch.tensor(r[2]) for r in ring)
        v = _blur(d0, d1, d2)                          # [UDC, nbv, 16]
        hb = _blur(v[:-2], v[1:-1], v[2:])              # [UW, nbv, 16]
        o, nbv, nco = d - 1, dd.shape[1], min(UN, co - c0)
        for j in range(UW):
            if q0 + j >= 2 * w:
                continue
            pre = hb[j, :, :nco].t() + nb[o, q0 + j, c0:c0 + nco, None]
            t[o, q0 + j, c0:c0 + nco, b0:b0 + nbv] = torch.where(
                pre >= 0, pre, 0.2 * pre)
    return t


def _inputs(ci, co, h, seed, b=3):
    rng = np.random.default_rng(seed)
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


@pytest.mark.parametrize("ci,co", SHAPES + [(32, 24)])
def test_pack_up_weights_follows_the_fragment_map(ci, co):
    """Every tap's B operand, read through the descriptor from its slice,
    row parity and k16 step, is k4's [16, 16] block (0 past Co)."""
    _, k4, _, _ = _inputs(ci, co, 2, seed=0)
    packed = tbc.pack_up_weights(k4)
    ncs = -(-co // 16)
    assert packed.dtype == torch.bfloat16
    assert packed.shape == (ncs, 2, ci // 16, 2, 4, 2, 2, 8, 8)
    pk = packed.float().numpy().reshape(ncs, 2, ci // 16, -1)
    kpad = F.pad(k4, (0, 16 * ncs - co)).numpy()
    for cs in range(ncs):
        for pr in range(2):
            for s in range(ci // 16):
                for a in range(2):
                    for kw in range(4):
                        got = _read_b(pk[cs, pr, s], (a * 4 + kw) * 512)
                        want = kpad[pr + 2 * a, kw, 16 * s:16 * s + 16,
                                    16 * cs:16 * cs + 16]
                        assert np.array_equal(got, want)


@pytest.mark.parametrize("h,rows", [(8, UROWS), (5, UROWS), (5, 4)])
@pytest.mark.parametrize("ci,co", SHAPES)
def test_emulated_deconv_matches_conv_transpose_and_jax(ci, co, h, rows):
    """The interior of the haloed grid is the transposed conv; its border
    (outputs -1 and 2H of the grid) is exactly 0; units that share halo
    rows (rows = 4: chunks of 4 output rows) or columns agree exactly."""
    x, k4, _, _ = _inputs(ci, co, h, seed=1)
    y = _haloed_grid(x.numpy(), tbc.pack_up_weights(k4), co, rows=rows)
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
    """The ring's blur (rows d - 2, d - 1, d into output row d - 1, no
    padding of its own), then +nb and lrelu, is _up_t's t in f32; the
    input affine touches in-image pixels only (staged pixels outside the
    image stay 0, not aff(0)). Every output is written."""
    x, k4, nb, aff = _inputs(ci, co, h, seed=2)
    t = _emulate_t(x.numpy(), tbc.pack_up_weights(k4), nb, co,
                   aff=aff.numpy() if apply_aff else None, rows=6)
    assert not torch.isnan(t).any()
    want = tbc._up_t(x, k4, nb, aff, apply_aff).permute(2, 3, 1, 0)
    _assert_close(t, want)


@pytest.mark.parametrize("b,gran", [(12, 4), (20, 4), (20, 2), (7, 1),
                                    (70, 2)])
def test_ragged_staging_writes_the_tma_layout(b, gran):
    """stage_ragged (the staging when B % 8 != 0, in granules of 4, 2 or 1
    samples) writes every sample below B where TMA would, 0 outside the
    image and at samples >= B; the deconvolution from it equals the
    transposed conv (B = 70: the second sample group holds 6)."""
    x, k4, _, _ = _inputs(16, 16, 3, seed=3, b=b)
    xs = x.numpy()
    for b0 in range(0, b, UM):
        for ma, n0 in ((-1, -1), (0, 1), (2, -1)):
            want = np.nan_to_num(_tma_stage(xs, ma, n0, 0, b0))
            got = _ragged_stage(xs, ma, n0, 0, b0, gran)
            assert np.array_equal(got, want)
    y = _haloed_grid(xs, tbc.pack_up_weights(k4), 16,
                     stage=lambda *a: _ragged_stage(*a, gran))
    wt = torch.flip(k4, (0, 1)).permute(2, 3, 0, 1)
    want = F.conv_transpose2d(x.permute(3, 2, 0, 1), wt, stride=2,
                              padding=1).permute(2, 3, 1, 0)
    _assert_close(y[1:-1, 1:-1], want)


def test_pack_up_weights_refuses_ragged_channels():
    with pytest.raises(ValueError, match="multiple of 16"):
        tbc.pack_up_weights(torch.zeros((4, 4, 24, 16)))
    with pytest.raises(ValueError, match="multiple of 16"):
        tbc.pack_up_weights(torch.zeros((4, 4, 16, 12)))
