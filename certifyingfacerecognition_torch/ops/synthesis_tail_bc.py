"""The StyleGAN >=512^2 synthesis tail in chain mode, in the [H, W, C, B]
layout: hand-written CUDA kernels (csrc/synthesis_tail_bc.cu) and their
plain PyTorch versions.

Chain mode: each layer's instance-norm + AdaIN is one affine (a, off) per
(channel, sample), computed from that layer's sums of t and t^2. A layer
writes its activation t RAW, and the NEXT layer applies the affine as it
reads its input, so a layer moves read(in) + write(out) bytes and no more.
The last conv layer has no reader, so it takes two passes: sums, then
apply + 1x1 ToRGB, emitting only the [3, H, W, B] image.

    up layer:   t = lrelu(blur3x3(convT4x4,s2(aff(x))) + nb)
    conv layer: t = lrelu(conv3x3(aff(x)) + nb)
    nb = noise * noise_weight + bias

Layouts follow the JAX package: x [H, W, Ci, B]; k4 [4, 4, Ci, Co] (the
forward-conv form of the 4x4 transposed conv: the spatially flipped torch
``conv_transpose2d`` kernel); k [3, 3, Ci, Co] with wscale folded in;
nb [H, W, Co]; aff/sums/coefs [2, C, B] in f32.

Every kernel has a wrapper that takes its plain version only for a tensor
on the CPU; a CUDA tensor launches the kernel or raises. ``LAUNCHES``
counts kernel launches per wrapper.

Rounding points (bf16 activations) match the Pallas kernels and are kept
by the plain versions: weights and nb are cast to the activation dtype;
the input affine is applied in the activation dtype; convolutions
accumulate in f32 (the deconv then rounds to the activation dtype, the 3x3
conv does not); the blur runs in the activation dtype; +nb and lrelu run
in f32; t is stored in the activation dtype and the sums use the f32 t.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

LAUNCHES: Dict[str, int] = {"up_fused": 0, "conv_fused": 0,
                            "final_stats": 0, "final_apply": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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

def _lrelu(t):
    return torch.where(t >= 0, t, 0.2 * t)


def _read(x, aff, apply_aff):
    """aff(x) in the activation dtype, as NCHW [B, Ci, H, W] f32 holding
    activation-dtype values."""
    if apply_aff:
        x = x * aff[0].to(x.dtype) + aff[1].to(x.dtype)
    return x.permute(3, 2, 0, 1).float()


def _sums(t):
    """[B, C, H, W] f32 -> [2, C, B]."""
    return torch.stack([t.sum((2, 3)), (t * t).sum((2, 3))]).transpose(1, 2)


def _conv_t(x, k, nb, aff, apply_aff):
    """t = lrelu(conv3x3(aff(x)) + nb) as NCHW f32."""
    dt = x.dtype
    y = F.conv2d(_read(x, aff, apply_aff),
                 k.to(dt).float().permute(3, 2, 0, 1), padding=1)
    return _lrelu(y + nb.to(dt).float().permute(2, 0, 1)[None])


def up_fused_ref(x, k4, nb, aff, *, apply_aff=True):
    """Plain version of up_fused: returns (t_raw [2H, 2W, Co, B],
    sums [2, Co, B])."""
    dt = x.dtype
    wt = torch.flip(k4.to(dt).float(), (0, 1)).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(_read(x, aff, apply_aff), wt, stride=2,
                           padding=1).to(dt)
    yp = F.pad(y, (1, 1, 1, 1))
    v = (yp[:, :, :-2] + yp[:, :, 2:]) * 0.25 + yp[:, :, 1:-1] * 0.5
    hb = (v[..., :-2] + v[..., 2:]) * 0.25 + v[..., 1:-1] * 0.5
    t = _lrelu(hb.float() + nb.to(dt).float().permute(2, 0, 1)[None])
    return t.to(dt).permute(2, 3, 1, 0).contiguous(), _sums(t)


def conv_fused_ref(x, k, nb, aff, *, apply_aff=True):
    """Plain version of conv_fused: returns (t_raw [H, W, Co, B],
    sums [2, Co, B])."""
    t = _conv_t(x, k, nb, aff, apply_aff)
    return t.to(x.dtype).permute(2, 3, 1, 0).contiguous(), _sums(t)


def final_stats_ref(x, k, nb, aff, *, apply_aff=True):
    """Plain version of final_stats: sums [2, Co, B] of the last conv."""
    return _sums(_conv_t(x, k, nb, aff, apply_aff))


def final_apply_ref(x, k, nb, aff, coefs, w_rgb, b_rgb, *, apply_aff=True):
    """Plain version of final_apply: the last conv, its own affine
    ``coefs`` [2, Co, B], then the 1x1 ToRGB (w_rgb [Co, 3] with 1/sqrt(Co)
    folded in, b_rgb [3]). Returns the image [3, H, W, B]."""
    dt = x.dtype
    t = _conv_t(x, k, nb, aff, apply_aff)                 # [B, Co, H, W]
    a = coefs[0].t()[:, :, None, None]
    off = coefs[1].t()[:, :, None, None]
    out = (t * a + off).to(dt).float()
    rgb = torch.einsum("bchw,cr->rhwb", out, w_rgb.to(dt).float())
    return (rgb + b_rgb.float()[:, None, None, None]).to(dt).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _cuda_args(x, weight, nb, aff, kshape, nb_hw, co_mult):
    """Check the inputs of a kernel launch; return (dtype code, f32 weight
    holding activation-dtype values, nb in the activation dtype, f32 aff,
    stream handle). Raises on anything the kernels do not take (Co must be
    a multiple of the kernel's channels per pass, ``co_mult``)."""
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
    if tuple(aff.shape) != (2, ci, b):
        raise ValueError(f"aff shape {tuple(aff.shape)} != {(2, ci, b)}")
    for t in (weight, nb, aff):
        if t.device != x.device:
            raise ValueError("all kernel inputs must be on one device")
    wf = weight.to(x.dtype).float().contiguous()
    return (_DTYPE_CODE[x.dtype], wf, nb.to(x.dtype).contiguous(),
            aff.float().contiguous(),
            torch.cuda.current_stream(x.device).cuda_stream)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {rc})")


def _lib():
    from .kernels import library

    return library("synthesis_tail_bc")


def up_fused(x, k4, nb, aff, *, apply_aff=True):
    """One-traversal up layer: (t_raw [2H, 2W, Co, B], sums [2, Co, B])."""
    if x.device.type == "cpu":
        return up_fused_ref(x, k4, nb, aff, apply_aff=apply_aff)
    h, w, ci, b = x.shape
    code, kf, nbt, af, stream = _cuda_args(x, k4, nb, aff, (4, 4),
                                           (2 * h, 2 * w), 8)
    co = kf.shape[3]
    out = torch.empty((2 * h, 2 * w, co, b), dtype=x.dtype, device=x.device)
    sums = torch.zeros((2, co, b), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().cfr_up_fused(code, x.data_ptr(), kf.data_ptr(),
                                 nbt.data_ptr(), af.data_ptr(),
                                 out.data_ptr(), sums.data_ptr(), h, w, ci,
                                 co, b, int(apply_aff), stream)
    _check(rc, "up_fused")
    LAUNCHES["up_fused"] += 1
    return out, sums


def conv_fused(x, k, nb, aff, *, apply_aff=True):
    """One-traversal conv layer: (t_raw [H, W, Co, B], sums [2, Co, B])."""
    if x.device.type == "cpu":
        return conv_fused_ref(x, k, nb, aff, apply_aff=apply_aff)
    h, w, ci, b = x.shape
    code, kf, nbt, af, stream = _cuda_args(x, k, nb, aff, (3, 3), (h, w),
                                           16)
    co = kf.shape[3]
    out = torch.empty((h, w, co, b), dtype=x.dtype, device=x.device)
    sums = torch.zeros((2, co, b), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().cfr_conv_fused(code, x.data_ptr(), kf.data_ptr(),
                                   nbt.data_ptr(), af.data_ptr(),
                                   out.data_ptr(), sums.data_ptr(), h, w, ci,
                                   co, b, int(apply_aff), stream)
    _check(rc, "conv_fused")
    LAUNCHES["conv_fused"] += 1
    return out, sums


def final_stats(x, k, nb, aff, *, apply_aff=True):
    """Sums pass of the last conv layer: sums [2, Co, B]."""
    if x.device.type == "cpu":
        return final_stats_ref(x, k, nb, aff, apply_aff=apply_aff)
    h, w, ci, b = x.shape
    code, kf, nbt, af, stream = _cuda_args(x, k, nb, aff, (3, 3), (h, w),
                                           16)
    co = kf.shape[3]
    sums = torch.zeros((2, co, b), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().cfr_final_stats(code, x.data_ptr(), kf.data_ptr(),
                                    nbt.data_ptr(), af.data_ptr(),
                                    sums.data_ptr(), h, w, ci, co, b,
                                    int(apply_aff), stream)
    _check(rc, "final_stats")
    LAUNCHES["final_stats"] += 1
    return sums


def final_apply(x, k, nb, aff, coefs, w_rgb, b_rgb, *, apply_aff=True):
    """Apply + ToRGB pass of the last conv layer: image [3, H, W, B]."""
    if x.device.type == "cpu":
        return final_apply_ref(x, k, nb, aff, coefs, w_rgb, b_rgb,
                               apply_aff=apply_aff)
    h, w, ci, b = x.shape
    code, kf, nbt, af, stream = _cuda_args(x, k, nb, aff, (3, 3), (h, w),
                                           16)
    co = kf.shape[3]
    if tuple(coefs.shape) != (2, co, b) or tuple(w_rgb.shape) != (co, 3) \
            or tuple(b_rgb.shape) != (3,):
        raise ValueError("coefs [2, Co, B], w_rgb [Co, 3], b_rgb [3] expected")
    cf = coefs.float().contiguous()
    wr = w_rgb.to(x.dtype).float().contiguous()
    br = b_rgb.float().contiguous()
    for t in (cf, wr, br):
        if t.device != x.device:
            raise ValueError("all kernel inputs must be on one device")
    img = torch.empty((3, h, w, b), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().cfr_final_apply(code, x.data_ptr(), kf.data_ptr(),
                                    nbt.data_ptr(), af.data_ptr(),
                                    cf.data_ptr(), wr.data_ptr(),
                                    br.data_ptr(), img.data_ptr(), h, w, ci,
                                    co, b, int(apply_aff), stream)
    _check(rc, "final_apply")
    LAUNCHES["final_apply"] += 1
    return img


# ---------------------------------------------------------------------------
# The chain of layers
# ---------------------------------------------------------------------------

def conv_rgb_final(x, k, nb, aff, s0p1, s1, w_rgb, b_rgb, eps, *,
                   apply_aff=True):
    """Last conv layer: sums pass, its own affine, then apply + ToRGB.
    Returns [3, H, W, B]; the Co-channel activation is never written."""
    h, w = x.shape[0], x.shape[1]
    sums = final_stats(x, k, nb, aff, apply_aff=apply_aff)
    coefs = coefs_from_sums(sums, h * w, s0p1.t(), s1.t(), eps)
    return final_apply(x, k, nb, aff, coefs, w_rgb, b_rgb,
                       apply_aff=apply_aff)


def tail_chain_bc(x: torch.Tensor, blocks: Sequence[Dict],
                  eps: float = 1e-8) -> torch.Tensor:
    """The >=512^2 tail as a chain of deferred-affine layers.

    x [H, W, Ci, B] is the NORMALISED output of the block before the tail,
    so the first layer reads it with no affine. blocks: dicts with k4
    [4,4,Ci,Co], up_nb [2H,2W,Co], up_s0p1/up_s1 [B,Co], k [3,3,Co,Co]
    (wscale folded), conv_nb, conv_s0p1, conv_s1, and on the LAST block
    w_rgb [Co,3] / b_rgb [3]. Returns the image [3, H_out, W_out, B]."""
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
