"""The StyleGAN synthesis epilogue in two streaming passes over each
activation: hand-written CUDA kernels (csrc/prefix_epilogue.cu: moments,
coefficients, apply) and their plain PyTorch version.

    t   = lrelu(x + nb)                      nb = noise * noise_weight + bias
    out = (t - mean(t)) * rsqrt(var(t) + eps) * (s0 + 1) + s1

mean and var over each (sample, channel) plane of the activation x; (s0,
s1) = style, the layer's AdaIN style. ``models/stylegan._epilogue`` takes
this path for a bf16 activation on the card that ``supports`` takes when no
autograd graph is being recorded (certification, generation, the gallery's
embedding), and its plain ops everywhere else (the CPU, f32, the attacks'
gradients, and the 512^2 and 1024^2 layers of a synthesis without the chain
tail).

Layouts and rounding points: x bf16 [B, C, H, W] in the channels-last
layout (memory [B, H, W, C], in which cuDNN runs the prefix's convolutions
and blur); the output in the same layout; nb bf16 [H, W, C] (``nb_of``,
folded in f32 as the chain tail folds it, and cast to bf16 as the chain
tail's kernels take it); style bf16 [B, 2C] (s0 then s1, as ``_style_dense``
computes it). Everything else is f32, rounding to bf16 once, at the store:
+nb and lrelu in f32 and s0 + 1 in f32, as in ops/synthesis_tail_bc.py.

The wrapper takes the plain version only for a tensor on the CPU; a CUDA
tensor launches the kernels or raises. It records no autograd graph and
raises on an input that requires grad. ``LAUNCHES`` counts the kernels'
calls (``prefix_epilogue``, one per epilogue, three launches each)
and the epilogues on the card that took the plain ops
(``prefix_epilogue_plain``, counted by ``_epilogue``).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models import nn

EPS = 1e-8
# the largest plane the kernels take: 256^2, the last of the synthesis
# prefix up to the chain tail's default boundary
MAX_PLANE = 256 * 256
MAX_CHUNKS = 32   # moment chunks of a sample (csrc/prefix_epilogue.cu)
LAUNCHES: Dict[str, int] = {"prefix_epilogue": 0, "prefix_epilogue_plain": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supports(c: int, h: int, w: int) -> bool:
    """Whether the kernels take [*, c, h, w] activations: c / 8 a power of
    two up to 256, h w a power of two up to MAX_PLANE, c h w >= 2048."""
    g, hw = c // 8, h * w
    return (c % 8 == 0 and 0 < g <= 256 and g & (g - 1) == 0
            and 0 < hw <= MAX_PLANE and hw & (hw - 1) == 0
            and c * hw >= 2048)


def nb_of(p: Dict) -> torch.Tensor:
    """noise * noise_weight + bias of a layer's parameters, f32 [H, W, C]."""
    return (p["noise"] * p["noise_weight"] + p["bias"]).float()


def prefix_epilogue_ref(x: torch.Tensor, nb: torch.Tensor,
                        style: torch.Tensor, eps: float = EPS
                        ) -> torch.Tensor:
    """Plain version: the formula in f32 (two-pass moments) on nb's and
    style's values, rounded to x's dtype at the end."""
    c = x.shape[1]
    s0p1 = style[:, :c].float() + 1.0
    s1 = style[:, c:].float()
    t = nn.lrelu(x.float() + nb.float().permute(2, 0, 1)[None])
    mean = t.mean((2, 3), keepdim=True)
    var = ((t - mean) ** 2).mean((2, 3), keepdim=True)
    out = ((t - mean) * torch.rsqrt(var + eps) * s0p1[:, :, None, None]
           + s1[:, :, None, None])
    return out.to(x.dtype)


def _check(x, nb, style) -> None:
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, nb, style)):
        raise RuntimeError(
            "prefix_epilogue: an input requires grad, and the kernels record "
            "no autograd graph; differentiate through the plain ops")
    for name, t in (("x", x), ("nb", nb), ("style", style)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"prefix_epilogue takes a bf16 {name}, got "
                             f"{t.dtype}")
        if t.device != x.device:
            raise ValueError("all inputs of prefix_epilogue must be on one "
                             "device")
    if x.dim() != 4 or not x.is_contiguous(
            memory_format=torch.channels_last):
        raise ValueError("x must be a [B, C, H, W] tensor in the "
                         "channels-last layout")
    b, c, h, w = x.shape
    if not supports(c, h, w):
        raise ValueError(f"the kernels do not take [{c}, {h}, {w}] "
                         f"activations (see supports)")
    if tuple(nb.shape) != (h, w, c):
        raise ValueError(f"nb shape {tuple(nb.shape)} != {(h, w, c)}")
    if tuple(style.shape) != (b, 2 * c):
        raise ValueError(f"style shape {tuple(style.shape)} != {(b, 2 * c)}")


def prefix_epilogue(x: torch.Tensor, nb: torch.Tensor,
                    style: torch.Tensor) -> torch.Tensor:
    """The epilogue of x as a new bf16 [B, C, H, W] tensor in x's layout
    (x is only read)."""
    _check(x, nb, style)
    if x.device.type == "cpu":
        return prefix_epilogue_ref(x, nb, style)
    from .kernels import library

    # the kernels move x, out and nb in 16-byte vectors
    x, nb = (t if t.data_ptr() % 16 == 0 else t.clone()
             for t in (x, nb.contiguous()))
    style = style.contiguous()
    b, c, h, w = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    part = torch.empty((b, MAX_CHUNKS, c, 2), dtype=torch.float32,
                       device=x.device)
    coef = torch.empty((b, c, 4), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = library("prefix_epilogue").cfr_prefix_epilogue(
            x.data_ptr(), nb.data_ptr(), style.data_ptr(), part.data_ptr(),
            coef.data_ptr(), out.data_ptr(), b, c, h * w,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"prefix_epilogue kernel launch failed (CUDA "
                           f"error {rc})")
    LAUNCHES["prefix_epilogue"] += 1
    return out
