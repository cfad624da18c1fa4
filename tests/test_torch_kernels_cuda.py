"""The hand-written CUDA kernels of the chain tail against their plain
PyTorch versions, on the GPU. Marked ``cuda``; without a CUDA device
every test skips (there is no CPU mode of a CUDA kernel). Run on a
machine with the card: ``python -m pytest --noconftest
tests/test_torch_kernels_cuda.py -m cuda`` (tests/conftest.py imports JAX,
which these tests do not need).

Tolerance: max |kernel - plain| <= 2^-6 x max |plain| in bf16 (two bf16
ulps at the top of the range: an intermediate that differs in its last
f32 bit can round the other way), 1e-4 x in f32; each row of the f32 sums
(sum t, sum t^2) to 1e-4 x its own largest value (atomics sum in another
order on every run)."""

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
    assert all(bc.LAUNCHES[n] == before[n] + 1 for n in bc.LAUNCHES)


def test_wrapper_raises_on_what_the_kernel_does_not_take(gen):
    x = _randn((8, 8, 16, 8), gen)
    aff = torch.stack([torch.ones((16, 8), device="cuda"),
                       torch.zeros((16, 8), device="cuda")])
    with pytest.raises(ValueError, match="multiple of 8"):
        bc.up_fused(x, _randn((4, 4, 16, 12), gen),
                    _randn((16, 16, 12), gen), aff)
    with pytest.raises(ValueError, match="multiple of 16"):
        bc.conv_fused(x, _randn((3, 3, 16, 8), gen),
                      _randn((8, 8, 8), gen), aff)
    with pytest.raises(ValueError, match="contiguous"):
        bc.conv_fused(x.transpose(0, 1), _randn((3, 3, 16, 16), gen),
                      _randn((8, 8, 16), gen), aff)
    with pytest.raises(ValueError, match="dtype"):
        bc.conv_fused(x.half(), _randn((3, 3, 16, 16), gen),
                      _randn((8, 8, 16), gen), aff)
