"""The StyleGAN >=512^2 synthesis tail in the [H, W, C, B] layout:
hand-written CUDA kernels (csrc/synthesis_tail_bc.cu), their plain PyTorch
versions, and the differentiable ops built on them.

Chain mode (``tail_chain_bc``, the path the pipeline runs): each layer's
instance-norm + AdaIN is one affine (a, off) per (channel, sample),
computed from that layer's sums of t and t^2. A layer writes its
activation t RAW, and the NEXT layer applies the affine as it reads its
input, so a layer moves read(in) + write(out) bytes and no more. The last
conv layer has no reader, so it takes two passes: sums, then apply + 1x1
ToRGB, emitting only the [3, H, W, B] image.

Standalone half-layers (``conv_epilogue_bc``, ``conv_epilogue_rgb_bc``,
``upconv_blur_epilogue_bc``): two passes over an already normalised input,
sums then apply with the layer's own affine.

    up layer:   t = lrelu(blur3x3(convT4x4,s2(aff(x))) + nb)
    conv layer: t = lrelu(conv3x3(aff(x)) + nb)
    nb = noise * noise_weight + bias

Layouts follow the JAX package: x [H, W, Ci, B]; k4 [4, 4, Ci, Co] (the
forward-conv form of the 4x4 transposed conv: the spatially flipped torch
``conv_transpose2d`` kernel); k [3, 3, Ci, Co] with wscale folded in;
nb [H, W, Co]; aff/sums/coefs [2, C, B] in f32; styles s0p1/s1 [B, Co].

Every kernel has a wrapper that takes its plain version only for a tensor
on the CPU; a CUDA tensor launches the kernel or raises. ``LAUNCHES``
counts kernel launches per wrapper. The wrappers record no autograd graph
and raise when handed an input that requires grad: the only way to
differentiate through a kernel is one of the autograd Functions below,
whose backward is the vjp of the plain reference (``_chain_ref``,
``_conv_ref``, ``_conv_rgb_ref``, ``_upconv_ref``) recomputed from the
saved inputs, as the JAX package's custom_vjp does.

Rounding points (bf16 activations) match the Pallas kernels and are kept
by the plain versions: weights and nb are cast to the activation dtype;
the input affine is applied in the activation dtype; convolutions
accumulate in f32 (the deconv then rounds to the activation dtype, the 3x3
conv does not); the blur runs in the activation dtype; +nb and lrelu run
in f32; t is stored in the activation dtype and the sums use the f32 t.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models import nn

LAUNCHES: Dict[str, int] = {
    "up_fused": 0, "conv_fused": 0, "final_stats": 0, "final_apply": 0,
    "conv_stats": 0, "conv_apply": 0, "conv_rgb_apply": 0, "up_stats": 0,
    "up_apply": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The kernels' sums are int64 fixed point in units of 2^-20, so that their
# value does not depend on the order of the atomic adds
# (csrc/synthesis_tail_bc.cu, design note).
_SUM_UNIT = 2.0 ** -20


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def coefs_from_sums(sums: torch.Tensor, n: int, s0p1_t: torch.Tensor,
                    s1_t: torch.Tensor, eps: float) -> torch.Tensor:
    """Fold instnorm + AdaIN into one (a, off) affine pair [2, C, B] f32.
    sums [2, C, B] over n output pixels; s0p1_t/s1_t [C, B]."""
    mean = sums[0] / n
    var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    a = rstd * s0p1_t
    off = (-mean * rstd) * s0p1_t + s1_t
    return torch.stack([a, off]).float()


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ---------------------------------------------------------------------------

def _read(x, aff, apply_aff):
    """aff(x) in the activation dtype, as NCHW [B, Ci, H, W] f32 holding
    activation-dtype values."""
    if apply_aff:
        x = x * aff[0].to(x.dtype) + aff[1].to(x.dtype)
    return x.permute(3, 2, 0, 1).float()


def _sums(t):
    """[B, C, H, W] f32 -> [2, C, B]."""
    return torch.stack([t.sum((2, 3)), (t * t).sum((2, 3))]).transpose(1, 2)


def _own_affine(t, coefs, dt):
    """A layer's own affine on its f32 t [B, Co, H, W], rounded to dt."""
    return (t * coefs[0].t()[:, :, None, None]
            + coefs[1].t()[:, :, None, None]).to(dt)


def _hwcb(t):
    """[B, C, H, W] -> contiguous [H, W, C, B]."""
    return t.permute(2, 3, 1, 0).contiguous()


def _conv_t(x, k, nb, aff, apply_aff):
    """t = lrelu(conv3x3(aff(x)) + nb) as NCHW f32."""
    dt = x.dtype
    y = F.conv2d(_read(x, aff, apply_aff),
                 k.to(dt).float().permute(3, 2, 0, 1), padding=1)
    return nn.lrelu(y + nb.to(dt).float().permute(2, 0, 1)[None])


def _up_t(x, k4, nb, aff, apply_aff):
    """t = lrelu(blur3x3(convT4x4,s2(aff(x))) + nb) as NCHW f32."""
    dt = x.dtype
    wt = torch.flip(k4.to(dt).float(), (0, 1)).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(_read(x, aff, apply_aff), wt, stride=2,
                           padding=1).to(dt)
    yp = F.pad(y, (1, 1, 1, 1))
    v = (yp[:, :, :-2] + yp[:, :, 2:]) * 0.25 + yp[:, :, 1:-1] * 0.5
    hb = (v[..., :-2] + v[..., 2:]) * 0.25 + v[..., 1:-1] * 0.5
    return nn.lrelu(hb.float() + nb.to(dt).float().permute(2, 0, 1)[None])


def up_fused_ref(x, k4, nb, aff, *, apply_aff=True):
    """Plain version of up_fused: returns (t_raw [2H, 2W, Co, B],
    sums [2, Co, B])."""
    t = _up_t(x, k4, nb, aff, apply_aff)
    return _hwcb(t.to(x.dtype)), _sums(t)


def conv_fused_ref(x, k, nb, aff, *, apply_aff=True):
    """Plain version of conv_fused: returns (t_raw [H, W, Co, B],
    sums [2, Co, B])."""
    t = _conv_t(x, k, nb, aff, apply_aff)
    return _hwcb(t.to(x.dtype)), _sums(t)


def final_stats_ref(x, k, nb, aff, *, apply_aff=True):
    """Plain version of final_stats: sums [2, Co, B] of the last conv."""
    return _sums(_conv_t(x, k, nb, aff, apply_aff))


def final_apply_ref(x, k, nb, aff, coefs, w_rgb, b_rgb, *, apply_aff=True):
    """Plain version of final_apply: the last conv, its own affine
    ``coefs`` [2, Co, B], then the 1x1 ToRGB (w_rgb [Co, 3] with 1/sqrt(Co)
    folded in, b_rgb [3]). Returns the image [3, H, W, B]."""
    dt = x.dtype
    out = _own_affine(_conv_t(x, k, nb, aff, apply_aff), coefs, dt).float()
    rgb = torch.einsum("bchw,cr->rhwb", out, w_rgb.to(dt).float())
    return (rgb + b_rgb.float()[:, None, None, None]).to(dt).contiguous()


def conv_stats_ref(x, k, nb):
    """Plain version of conv_stats: sums [2, Co, B] of
    t = lrelu(conv3x3(x) + nb), no input affine."""
    return final_stats_ref(x, k, nb, None, apply_aff=False)


def conv_apply_ref(x, k, nb, coefs):
    """Plain version of conv_apply: the layer's own affine on t,
    [H, W, Co, B] in the activation dtype."""
    return _hwcb(_own_affine(_conv_t(x, k, nb, None, False), coefs, x.dtype))


def conv_rgb_apply_ref(x, k, nb, coefs, w_rgb, b_rgb):
    """Plain version of conv_rgb_apply: conv_apply fused with the ToRGB,
    the image [3, H, W, B]."""
    return final_apply_ref(x, k, nb, None, coefs, w_rgb, b_rgb,
                           apply_aff=False)


def up_stats_ref(x, k4, nb):
    """Plain version of up_stats: sums [2, Co, B] of the up layer's t, no
    input affine."""
    return _sums(_up_t(x, k4, nb, None, False))


def up_apply_ref(x, k4, nb, coefs):
    """Plain version of up_apply: the up layer's own affine on t,
    [2H, 2W, Co, B] in the activation dtype."""
    return _hwcb(_own_affine(_up_t(x, k4, nb, None, False), coefs, x.dtype))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _forbid_grad(name, *tensors):
    """The kernels record no graph: refuse an input that requires grad
    instead of returning a result whose gradient is silently lost."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel wrappers record "
            "no autograd graph; differentiate through tail_chain_bc, "
            "conv_epilogue_bc, conv_epilogue_rgb_bc or "
            "upconv_blur_epilogue_bc")


def _cuda_args(x, weight, nb, aff, kshape, nb_hw, co_mult):
    """Check the inputs of a kernel launch; return (dtype code, f32 weight
    holding activation-dtype values, nb in the activation dtype, f32 aff
    (None without an input affine), stream handle). Raises on anything the
    kernels do not take (Co must be a multiple of the kernel's channels per
    pass, ``co_mult``)."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported activation dtype {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [H, W, C, B] tensor")
    h, w, ci, b = x.shape
    co = weight.shape[-1]
    if tuple(weight.shape) != (*kshape, ci, co):
        raise ValueError(f"weight shape {tuple(weight.shape)} does not fit "
                         f"x {tuple(x.shape)}")
    if co % co_mult:
        raise ValueError(f"output channels must be a multiple of {co_mult}, "
                         f"got {co}")
    if tuple(nb.shape) != (*nb_hw, co):
        raise ValueError(f"nb shape {tuple(nb.shape)} != {(*nb_hw, co)}")
    if aff is not None and tuple(aff.shape) != (2, ci, b):
        raise ValueError(f"aff shape {tuple(aff.shape)} != {(2, ci, b)}")
    for t in (weight, nb, aff):
        if t is not None and t.device != x.device:
            raise ValueError("all kernel inputs must be on one device")
    wf = weight.to(x.dtype).float().contiguous()
    af = None if aff is None else aff.float().contiguous()
    return (_DTYPE_CODE[x.dtype], wf, nb.to(x.dtype).contiguous(), af,
            torch.cuda.current_stream(x.device).cuda_stream)


def pack_mma_weights(k: torch.Tensor) -> torch.Tensor:
    """k [kh, kw, Ci, Co] -> the bf16 kernels' weights in the order of the
    B fragments of ``mma.m16n8k16`` (K = input channels, N = output
    channels): [kh, kw, Co/8, Ci/16, 32, 4]. Entry [dy, dx, cc, s, 4g + t]
    is what lane 4g + t of a warp holds for output channel 8cc + g and
    the input channels 16s + 2t + (0, 1, 8, 9), so each lane loads its
    fragment of one (tap, 8 output channels, 16 input channels) step with
    one 8-byte load. The values are cast to bf16 (exact for weights that
    already hold bf16 values)."""
    kh, kw, ci, co = k.shape
    if ci % 16 or co % 8:
        raise ValueError(f"pack_mma_weights takes [kh, kw, Ci, Co] with Ci a "
                         f"multiple of 16 and Co of 8, got {tuple(k.shape)}")
    # input channel 16s + 8h + 2t + p, output channel 8cc + g
    kk = k.to(torch.bfloat16).reshape(kh, kw, ci // 16, 2, 4, 2, co // 8, 8)
    return kk.permute(0, 1, 6, 2, 7, 4, 3, 5).reshape(
        kh, kw, co // 8, ci // 16, 32, 4).contiguous()


def pack_up_weights(k4: torch.Tensor) -> torch.Tensor:
    """k4 [4, 4, Ci, Co] -> the bf16 up kernel's weights, the B operands of
    its ``wgmma.m64n16k16`` (K = 16 input channels, N = 16 output channels,
    K-major without swizzle: 8x8 core matrices of 128 bytes):
    [ceil(Co/16), 2, Ci/16, 2, 4, 2, 2, 8, 8]. Entry
    [cs, pr, s, a, kw, ng, kc, r, e] is k4[pr + 2a, kw, 16s + 8kc + e,
    16cs + 8ng + r], 0 for an output channel >= Co: per slice of 16 output
    channels cs, output row parity pr and k16 step s, the 8 taps that rows
    of that parity read, 4 KB in one piece (one bulk copy per stage). The
    values are cast to bf16 (exact for weights that already hold bf16
    values)."""
    if tuple(k4.shape[:2]) != (4, 4) or k4.shape[2] % 16 or k4.shape[3] % 8:
        raise ValueError(f"pack_up_weights takes [4, 4, Ci, Co] with Ci a "
                         f"multiple of 16 and Co of 8, got {tuple(k4.shape)}")
    ci, co = k4.shape[2:]
    ncs = -(-co // 16)
    kk = F.pad(k4.to(torch.bfloat16), (0, 16 * ncs - co))
    # kh = 2a + pr, input channel 16s + 8kc + e, output channel 16cs + 8ng + r
    kk = kk.reshape(2, 2, 4, ci // 16, 2, 8, ncs, 2, 8)
    return kk.permute(6, 1, 3, 0, 2, 7, 4, 8, 5).contiguous()


def _layer_args(x, weight, nb, aff, up):
    """_cuda_args of an up-layer (``up``) or conv-layer launch, returning
    (dtype code, weights, Co, nb, aff, stream). The bf16 kernels run on
    the tensor cores: they take their weights packed (pack_up_weights,
    pack_mma_weights) and need Ci a multiple of 16."""
    h, w, ci, _ = x.shape
    code, kf, nbt, af, stream = _cuda_args(
        x, weight, nb, aff, (4, 4) if up else (3, 3),
        (2 * h, 2 * w) if up else (h, w), 8 if up else 16)
    co = kf.shape[3]
    if x.dtype == torch.bfloat16:
        if ci % 16:
            raise ValueError(f"the bf16 {'up' if up else 'conv'} kernel needs "
                             f"input channels a multiple of 16, got {ci}")
        kf = pack_up_weights(kf) if up else pack_mma_weights(kf)
        if up and nbt.data_ptr() % 16:
            # the up kernel loads nb by TMA, from a 16-byte aligned address
            nbt = nbt.clone()
    return code, kf, co, nbt, af, stream


def _coefs_arg(coefs, co, b, device):
    if tuple(coefs.shape) != (2, co, b) or coefs.device != device:
        raise ValueError(f"coefs must be [2, {co}, {b}] on {device}")
    return coefs.float().contiguous()


def _rgb_args(w_rgb, b_rgb, co, x):
    if tuple(w_rgb.shape) != (co, 3) or tuple(b_rgb.shape) != (3,):
        raise ValueError("w_rgb [Co, 3] and b_rgb [3] expected")
    wr = w_rgb.to(x.dtype).float().contiguous()
    br = b_rgb.float().contiguous()
    if wr.device != x.device or br.device != x.device:
        raise ValueError("all kernel inputs must be on one device")
    return wr, br


def _sums_buffer(co, b, device):
    return torch.zeros((2, co, b), dtype=torch.int64, device=device)


def _sums_f32(acc):
    """The kernels' fixed-point sums as f32 [2, Co, B]."""
    return (acc.double() * _SUM_UNIT).float()


def _launch(name, fn, *args):
    """Call one C entry point on the inputs' device; raise on a launch
    error; count the launch."""
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {rc})")
    LAUNCHES[name] += 1


def _lib():
    from .kernels import library

    return library("synthesis_tail_bc")


def up_fused(x, k4, nb, aff, *, apply_aff=True):
    """One-traversal up layer: (t_raw [2H, 2W, Co, B], sums [2, Co, B])."""
    _forbid_grad("up_fused", x, k4, nb, aff)
    if x.device.type == "cpu":
        return up_fused_ref(x, k4, nb, aff, apply_aff=apply_aff)
    h, w, ci, b = x.shape
    code, kf, co, nbt, af, stream = _layer_args(x, k4, nb, aff, up=True)
    out = torch.empty((2 * h, 2 * w, co, b), dtype=x.dtype, device=x.device)
    sums = _sums_buffer(co, b, x.device)
    with torch.cuda.device(x.device):
        _launch("up_fused", _lib().cfr_up_fused, code, x.data_ptr(),
                kf.data_ptr(), nbt.data_ptr(), af.data_ptr(), out.data_ptr(),
                sums.data_ptr(), h, w, ci, co, b, int(apply_aff), stream)
    return out, _sums_f32(sums)


def conv_fused(x, k, nb, aff, *, apply_aff=True):
    """One-traversal conv layer: (t_raw [H, W, Co, B], sums [2, Co, B])."""
    _forbid_grad("conv_fused", x, k, nb, aff)
    if x.device.type == "cpu":
        return conv_fused_ref(x, k, nb, aff, apply_aff=apply_aff)
    h, w, ci, b = x.shape
    code, kf, co, nbt, af, stream = _layer_args(x, k, nb, aff, up=False)
    out = torch.empty((h, w, co, b), dtype=x.dtype, device=x.device)
    sums = _sums_buffer(co, b, x.device)
    with torch.cuda.device(x.device):
        _launch("conv_fused", _lib().cfr_conv_fused, code, x.data_ptr(),
                kf.data_ptr(), nbt.data_ptr(), af.data_ptr(), out.data_ptr(),
                sums.data_ptr(), h, w, ci, co, b, int(apply_aff), stream)
    return out, _sums_f32(sums)


def final_stats(x, k, nb, aff, *, apply_aff=True):
    """Sums pass of the last conv layer: sums [2, Co, B]."""
    _forbid_grad("final_stats", x, k, nb, aff)
    if x.device.type == "cpu":
        return final_stats_ref(x, k, nb, aff, apply_aff=apply_aff)
    h, w, ci, b = x.shape
    code, kf, co, nbt, af, stream = _layer_args(x, k, nb, aff, up=False)
    sums = _sums_buffer(co, b, x.device)
    with torch.cuda.device(x.device):
        _launch("final_stats", _lib().cfr_final_stats, code, x.data_ptr(),
                kf.data_ptr(), nbt.data_ptr(), af.data_ptr(),
                sums.data_ptr(), h, w, ci, co, b, int(apply_aff), stream)
    return _sums_f32(sums)


def final_apply(x, k, nb, aff, coefs, w_rgb, b_rgb, *, apply_aff=True):
    """Apply + ToRGB pass of the last conv layer: image [3, H, W, B]."""
    _forbid_grad("final_apply", x, k, nb, aff, coefs, w_rgb, b_rgb)
    if x.device.type == "cpu":
        return final_apply_ref(x, k, nb, aff, coefs, w_rgb, b_rgb,
                               apply_aff=apply_aff)
    h, w, ci, b = x.shape
    code, kf, co, nbt, af, stream = _layer_args(x, k, nb, aff, up=False)
    cf = _coefs_arg(coefs, co, b, x.device)
    wr, br = _rgb_args(w_rgb, b_rgb, co, x)
    img = torch.empty((3, h, w, b), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _launch("final_apply", _lib().cfr_final_apply, code, x.data_ptr(),
                kf.data_ptr(), nbt.data_ptr(), af.data_ptr(), cf.data_ptr(),
                wr.data_ptr(), br.data_ptr(), img.data_ptr(), h, w, ci, co,
                b, int(apply_aff), stream)
    return img


def conv_stats(x, k, nb):
    """Sums pass of a standalone conv half-layer: sums [2, Co, B]."""
    _forbid_grad("conv_stats", x, k, nb)
    if x.device.type == "cpu":
        return conv_stats_ref(x, k, nb)
    h, w, ci, b = x.shape
    code, kf, co, nbt, _, stream = _layer_args(x, k, nb, None, up=False)
    sums = _sums_buffer(co, b, x.device)
    with torch.cuda.device(x.device):
        _launch("conv_stats", _lib().cfr_conv_stats, code, x.data_ptr(),
                kf.data_ptr(), nbt.data_ptr(), sums.data_ptr(), h, w, ci, co,
                b, stream)
    return _sums_f32(sums)


def conv_apply(x, k, nb, coefs):
    """Apply pass of a standalone conv half-layer: [H, W, Co, B]."""
    _forbid_grad("conv_apply", x, k, nb, coefs)
    if x.device.type == "cpu":
        return conv_apply_ref(x, k, nb, coefs)
    h, w, ci, b = x.shape
    code, kf, co, nbt, _, stream = _layer_args(x, k, nb, None, up=False)
    cf = _coefs_arg(coefs, co, b, x.device)
    out = torch.empty((h, w, co, b), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _launch("conv_apply", _lib().cfr_conv_apply, code, x.data_ptr(),
                kf.data_ptr(), nbt.data_ptr(), cf.data_ptr(), out.data_ptr(),
                h, w, ci, co, b, stream)
    return out


def conv_rgb_apply(x, k, nb, coefs, w_rgb, b_rgb):
    """Apply pass of a standalone conv half-layer fused with the ToRGB:
    image [3, H, W, B]."""
    _forbid_grad("conv_rgb_apply", x, k, nb, coefs, w_rgb, b_rgb)
    if x.device.type == "cpu":
        return conv_rgb_apply_ref(x, k, nb, coefs, w_rgb, b_rgb)
    h, w, ci, b = x.shape
    code, kf, co, nbt, _, stream = _layer_args(x, k, nb, None, up=False)
    cf = _coefs_arg(coefs, co, b, x.device)
    wr, br = _rgb_args(w_rgb, b_rgb, co, x)
    img = torch.empty((3, h, w, b), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _launch("conv_rgb_apply", _lib().cfr_conv_rgb_apply, code,
                x.data_ptr(), kf.data_ptr(), nbt.data_ptr(), cf.data_ptr(),
                wr.data_ptr(), br.data_ptr(), img.data_ptr(), h, w, ci, co,
                b, stream)
    return img


def up_stats(x, k4, nb):
    """Sums pass of a standalone up half-layer: sums [2, Co, B]."""
    _forbid_grad("up_stats", x, k4, nb)
    if x.device.type == "cpu":
        return up_stats_ref(x, k4, nb)
    h, w, ci, b = x.shape
    code, kf, co, nbt, _, stream = _layer_args(x, k4, nb, None, up=True)
    sums = _sums_buffer(co, b, x.device)
    with torch.cuda.device(x.device):
        _launch("up_stats", _lib().cfr_up_stats, code, x.data_ptr(),
                kf.data_ptr(), nbt.data_ptr(), sums.data_ptr(), h, w, ci, co,
                b, stream)
    return _sums_f32(sums)


def up_apply(x, k4, nb, coefs):
    """Apply pass of a standalone up half-layer: [2H, 2W, Co, B]."""
    _forbid_grad("up_apply", x, k4, nb, coefs)
    if x.device.type == "cpu":
        return up_apply_ref(x, k4, nb, coefs)
    h, w, ci, b = x.shape
    code, kf, co, nbt, _, stream = _layer_args(x, k4, nb, None, up=True)
    cf = _coefs_arg(coefs, co, b, x.device)
    out = torch.empty((2 * h, 2 * w, co, b), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _launch("up_apply", _lib().cfr_up_apply, code, x.data_ptr(),
                kf.data_ptr(), nbt.data_ptr(), cf.data_ptr(), out.data_ptr(),
                h, w, ci, co, b, stream)
    return out


# ---------------------------------------------------------------------------
# Plain references: the backward of every op below (JAX l.87-123, 1388)
# ---------------------------------------------------------------------------

def _nchw(x_cb):
    return x_cb.permute(3, 2, 0, 1)


def _cb(x):
    return x.permute(2, 3, 1, 0)


def _epilogue_ref(t, nb, s0p1, s1, eps):
    """noise+bias, lrelu, instance norm, AdaIN on t [B, C, H, W]; nb and
    the styles are f32, so the arithmetic runs in f32 and the result is
    cast back to t's dtype (the Pallas forward's output dtype)."""
    dtype = t.dtype
    t = nn.lrelu(t + nb.permute(2, 0, 1)[None])
    t = nn.instance_norm(t, eps=eps)
    return (t * s0p1[:, :, None, None] + s1[:, :, None, None]).to(dtype)


def _conv_ref(x_cb, k_hwio, nb, s0p1, s1, eps):
    y = nn.conv2d(_nchw(x_cb), k_hwio.to(x_cb.dtype), padding=1)
    return _cb(_epilogue_ref(y, nb, s0p1, s1, eps))


def _conv_rgb_ref(x_cb, k_hwio, nb, s0p1, s1, w_rgb, b_rgb, eps):
    y = nn.conv2d(_nchw(x_cb), k_hwio.to(x_cb.dtype), padding=1)
    out = _epilogue_ref(y, nb, s0p1, s1, eps)
    rgb = torch.einsum("bchw,cd->dhwb", out, w_rgb.to(out.dtype))
    return (rgb + b_rgb[:, None, None, None]).to(x_cb.dtype)


def _upconv_ref(x_cb, k4_hwio, nb, s0p1, s1, eps):
    y = nn.blur_3x3(nn.upconv(_nchw(x_cb), k4_hwio.to(x_cb.dtype)))
    return _cb(_epilogue_ref(y, nb, s0p1, s1, eps))


def _chain_ref(x, blocks, eps, remat=False):
    """The whole tail on plain ops. remat=True is the JAX package's memory
    discipline: each half-layer is its own checkpoint, so the backward
    holds one half-layer's activations instead of the whole tail's."""
    def call(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    cur = x
    for li, b in enumerate(blocks):
        cur = call(_upconv_ref, cur, b["k4"], b["up_nb"], b["up_s0p1"],
                   b["up_s1"], eps)
        if li < len(blocks) - 1:
            cur = call(_conv_ref, cur, b["k"], b["conv_nb"], b["conv_s0p1"],
                       b["conv_s1"], eps)
        else:
            return call(_conv_rgb_ref, cur, b["k"], b["conv_nb"],
                        b["conv_s0p1"], b["conv_s1"], b["w_rgb"], b["b_rgb"],
                        eps)
    raise ValueError("the tail needs at least one block")


# ---------------------------------------------------------------------------
# Differentiable ops: kernels forward, the plain reference's vjp backward
# ---------------------------------------------------------------------------

class _KernelsForward(torch.autograd.Function):
    """forward: ``impl(*inputs)`` (the kernels on CUDA, their plain
    versions on the CPU), recording nothing; saved: the inputs only;
    backward: the vjp of ``ref(*inputs)``, recomputed from the saved
    inputs, for every input that needs a gradient."""

    @staticmethod
    def forward(ctx, impl: Callable, ref: Callable, *inputs):
        ctx.ref = ref
        ctx.save_for_backward(*inputs)
        return impl(*inputs)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            wrt = [t for t, n in zip(leaves, needs) if n]
            grads = iter(torch.autograd.grad(ctx.ref(*leaves), wrt, grad)
                         if wrt else ())
        return (None, None) + tuple(next(grads) if n else None
                                    for n in needs)


def _conv_impl(x, k_hwio, nb, s0p1, s1, eps, w_rgb=None, b_rgb=None):
    """Two passes: sums, the layer's own affine, then apply (with the
    ToRGB when w_rgb/b_rgb are given)."""
    sums = conv_stats(x, k_hwio, nb)
    coefs = coefs_from_sums(sums, x.shape[0] * x.shape[1], s0p1.t(), s1.t(),
                            eps)
    if w_rgb is None:
        return conv_apply(x, k_hwio, nb, coefs)
    return conv_rgb_apply(x, k_hwio, nb, coefs, w_rgb, b_rgb)


def _up_impl(x, k4_hwio, nb, s0p1, s1, eps):
    sums = up_stats(x, k4_hwio, nb)
    coefs = coefs_from_sums(sums, 4 * x.shape[0] * x.shape[1], s0p1.t(),
                            s1.t(), eps)
    return up_apply(x, k4_hwio, nb, coefs)


def conv_epilogue_bc(x, k_hwio, nb, s0p1, s1, eps=1e-8):
    """conv3x3 -> +noise+bias -> lrelu -> instnorm -> AdaIN in the
    [H, W, C, B] layout. x [H, W, Ci, B]; k_hwio [3,3,Ci,Co] with wscale
    folded in; nb = noise*noise_weight + bias [H, W, Co]; s0p1/s1 [B, Co].
    Returns [H, W, Co, B]."""
    return _KernelsForward.apply(
        lambda *a: _conv_impl(*a, eps), lambda *a: _conv_ref(*a, eps),
        x, k_hwio, nb, s0p1, s1)


def conv_epilogue_rgb_bc(x, k_hwio, nb, s0p1, s1, w_rgb, b_rgb, eps=1e-8):
    """conv_epilogue_bc with the 1x1 ToRGB fused into the apply pass.
    w_rgb [Co, 3] (1/sqrt(Co) folded in); b_rgb [3]. Returns [3, H, W, B]."""
    return _KernelsForward.apply(
        lambda x, k, nb, s0, s1, w, b: _conv_impl(x, k, nb, s0, s1, eps, w,
                                                  b),
        lambda *a: _conv_rgb_ref(*a, eps),
        x, k_hwio, nb, s0p1, s1, w_rgb, b_rgb)


def upconv_blur_epilogue_bc(x, k4_hwio, nb, s0p1, s1, eps=1e-8):
    """4x4 stride-2 up-conv -> blur3x3 -> +noise+bias -> lrelu -> instnorm
    -> AdaIN in the [H, W, C, B] layout. x [H, W, Ci, B]; k4_hwio
    [4,4,Ci,Co]; nb [2H, 2W, Co]; s0p1/s1 [B, Co]. Returns [2H,2W,Co,B]."""
    return _KernelsForward.apply(
        lambda *a: _up_impl(*a, eps), lambda *a: _upconv_ref(*a, eps),
        x, k4_hwio, nb, s0p1, s1)


def conv_rgb_final(x, k, nb, aff, s0p1, s1, w_rgb, b_rgb, eps, *,
                   apply_aff=True):
    """Last conv layer: sums pass, its own affine, then apply + ToRGB.
    Returns [3, H, W, B]; the Co-channel activation is never written."""
    h, w = x.shape[0], x.shape[1]
    sums = final_stats(x, k, nb, aff, apply_aff=apply_aff)
    coefs = coefs_from_sums(sums, h * w, s0p1.t(), s1.t(), eps)
    return final_apply(x, k, nb, aff, coefs, w_rgb, b_rgb,
                       apply_aff=apply_aff)


def _chain_impl(x, blocks, eps):
    b = x.shape[3]
    aff = torch.stack([torch.ones((x.shape[2], b), device=x.device),
                       torch.zeros((x.shape[2], b), device=x.device)])
    cur = x
    for li, blk in enumerate(blocks):
        cur, sums = up_fused(cur, blk["k4"], blk["up_nb"], aff,
                             apply_aff=li > 0)
        n = cur.shape[0] * cur.shape[1]
        aff = coefs_from_sums(sums, n, blk["up_s0p1"].t(),
                              blk["up_s1"].t(), eps)
        if li < len(blocks) - 1:
            cur, sums = conv_fused(cur, blk["k"], blk["conv_nb"], aff)
            aff = coefs_from_sums(sums, n, blk["conv_s0p1"].t(),
                                  blk["conv_s1"].t(), eps)
        else:
            return conv_rgb_final(cur, blk["k"], blk["conv_nb"], aff,
                                  blk["conv_s0p1"], blk["conv_s1"],
                                  blk["w_rgb"], blk["b_rgb"], eps)
    raise ValueError("tail_chain_bc needs at least one block")


def tail_chain_bc(x: torch.Tensor, blocks: Sequence[Dict],
                  eps: float = 1e-8) -> torch.Tensor:
    """The >=512^2 tail as a chain of deferred-affine layers.

    x [H, W, Ci, B] is the NORMALISED output of the block before the tail,
    so the first layer reads it with no affine. blocks: dicts with k4
    [4,4,Ci,Co], up_nb [2H,2W,Co], up_s0p1/up_s1 [B,Co], k [3,3,Co,Co]
    (wscale folded), conv_nb, conv_s0p1, conv_s1, and on the LAST block
    w_rgb [Co,3] / b_rgb [3]. Returns the image [3, H_out, W_out, B].

    Differentiable: the backward is the vjp of the plain chain with one
    checkpoint per half-layer (_chain_ref(remat=True)), the JAX package's
    _chain_bwd; x and every block tensor that requires grad (the styles,
    on the attack path) get a gradient."""
    keys = [tuple(blk) for blk in blocks]
    flat = [blk[k] for blk, ks in zip(blocks, keys) for k in ks]

    def rebuild(flat):
        it = iter(flat)
        return [{k: next(it) for k in ks} for ks in keys]

    return _KernelsForward.apply(
        lambda x, *f: _chain_impl(x, rebuild(f), eps),
        lambda x, *f: _chain_ref(x, rebuild(f), eps, remat=True),
        x, *flat)
