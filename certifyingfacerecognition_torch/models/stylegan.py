"""StyleGAN-1 generator (FFHQ), PyTorch port of
certifyingfacerecognition_tpu/models/stylegan.py.

Parameters are a nested dict of tensors with the JAX package's keys and
layouts (HWIO kernels, [in, out] dense weights, [H, W, C] noise, the 4x4
transposed-conv kernel precomputed in forward-conv form); activations are
NCHW. The weights are frozen (requires_grad=False); gradients flow to the
latents.

bf16 runs the synthesis blocks from CFR_TAIL_MIN_RES (default 512, floor
128) upward as the chain tail of ops/synthesis_tail_bc.py when CFR_TAIL=bc
(hand-written CUDA kernels on the GPU); the f32 path always runs plain ops.

With grad enabled (the attack path), every synthesis block on plain ops is
rematerialised in the backward pass (one checkpoint per block), and a
block whose input is >= 256^2 also checkpoints each of its two
half-layers, the JAX package's memory discipline: the backward then holds
one half-layer's activations instead of the whole 1024^2 synthesis. With
grad off nothing is checkpointed.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import nn
from ..constants import STYLEGAN_TRUNCATION_LAYERS, STYLEGAN_TRUNCATION_PSI
from ..utils.device import resolve_device
from ..utils.weights import to_torch

# Resolution -> per-block channel counts.
RESOLUTIONS_TO_CHANNELS = {
    8: [512, 512, 512],
    16: [512, 512, 512, 512],
    32: [512, 512, 512, 512, 512],
    64: [512, 512, 512, 512, 512, 256],
    128: [512, 512, 512, 512, 512, 256, 128],
    256: [512, 512, 512, 512, 512, 256, 128, 64],
    512: [512, 512, 512, 512, 512, 256, 128, 64, 32],
    1024: [512, 512, 512, 512, 512, 256, 128, 64, 32, 16],
}

# Minimal resolution of the fused-scale (transposed conv) up layers.
AUTO_FUSED_SCALE_MIN_RES = 128

W_DIM = 512
MAPPING_LAYERS = 8
MAPPING_LR_MULT = 0.01


def num_layers(resolution: int) -> int:
    return int(np.log2(resolution)) * 2 - 2


def is_fused_layer(layer_idx: int) -> bool:
    """Up-conv layers at resolution >= 128 use the fused transposed conv."""
    return 2 ** (layer_idx // 2 + 2) >= AUTO_FUSED_SCALE_MIN_RES


def _wscale(fan_in: int, gain: float = math.sqrt(2.0),
            lr_mult: float = 1.0) -> float:
    """Runtime equalised-lr scale."""
    return gain / math.sqrt(fan_in) * lr_mult


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def mapping_apply(params: Dict, z: torch.Tensor, *,
                  dtype=torch.float32) -> torch.Tensor:
    """8-layer mapping network Z [B, 512] -> W [B, 512]."""
    x = nn.pixel_norm(z.to(dtype))
    scale = _wscale(W_DIM, lr_mult=MAPPING_LR_MULT)
    for i in range(MAPPING_LAYERS):
        p = params["mapping"][f"dense{i}"]
        x = x @ p["weight"].to(dtype)
        x = x * scale + p["bias"].to(dtype) * MAPPING_LR_MULT
        x = nn.lrelu(x)
    return x


def truncation_apply(params: Dict, w: torch.Tensor, *, resolution: int,
                     truncation_psi: Optional[float] = STYLEGAN_TRUNCATION_PSI,
                     truncation_layers: int = STYLEGAN_TRUNCATION_LAYERS
                     ) -> torch.Tensor:
    """W [B, 512] -> W+ [B, L, 512] with psi-truncation toward w_avg."""
    L = num_layers(resolution)
    wp = w[:, None, :].expand(w.shape[0], L, W_DIM) if w.dim() == 2 else w
    if truncation_psi is None:
        return wp
    coefs = np.ones((1, L, 1), np.float32)
    coefs[:, :truncation_layers, :] *= truncation_psi
    w_avg = params["truncation"]["w_avg"].reshape(1, 1, W_DIM)
    return w_avg + (wp - w_avg) * torch.as_tensor(coefs, dtype=wp.dtype,
                                                  device=wp.device)


def _style(p: Dict, w_layer: torch.Tensor, c: int, *, dtype):
    """AdaIN style affine (s0, s1), each [B, C]."""
    style = w_layer @ p["style_weight"].to(dtype)
    style = style * _wscale(W_DIM, gain=1.0) + p["style_bias"].to(dtype)
    return style[:, :c], style[:, c:]


def _chw(v: torch.Tensor) -> torch.Tensor:
    """[H, W, C] -> [1, C, H, W]."""
    return v.permute(2, 0, 1)[None]


def _epilogue(p: Dict, x: torch.Tensor, w_layer: torch.Tensor, *,
              dtype) -> torch.Tensor:
    """noise -> bias -> lrelu -> instance-norm -> AdaIN style modulation."""
    noise = _chw(p["noise"].to(dtype))
    x = x + noise * p["noise_weight"].to(dtype)[None, :, None, None]
    x = x + p["bias"].to(dtype)[None, :, None, None]
    x = nn.lrelu(x)
    x = nn.instance_norm(x)
    s0, s1 = _style(p, w_layer, x.shape[1], dtype=dtype)
    return x * (s0[:, :, None, None] + 1.0) + s1[:, :, None, None]


def _bc_first_block(resolution: int, dtype) -> int:
    """First synthesis block run by the chain tail, or n_blocks+1 when the
    tail is off. Block bi's output resolution is 2^(bi+1); the cut point is
    CFR_TAIL_MIN_RES (default 512), floored at the first fused-upconv block
    (128^2). bf16 only; the f32 path stays on plain ops."""
    n_blocks = len(RESOLUTIONS_TO_CHANNELS[resolution]) - 1
    if os.environ.get("CFR_TAIL", "") != "bc" or dtype != torch.bfloat16:
        return n_blocks + 1
    min_res = int(os.environ.get("CFR_TAIL_MIN_RES", "512"))
    return max(6, int(np.log2(min_res)) - 1)


def bc_tail_active(resolution: int, dtype) -> bool:
    """True when synthesis_apply will end in the chain tail (and can hand
    the image on in the tail's [3, H, W, B] layout)."""
    n_blocks = len(RESOLUTIONS_TO_CHANNELS[resolution]) - 1
    return _bc_first_block(resolution, dtype) <= n_blocks


def cb_out_active(resolution: int, dtype) -> bool:
    """True when the pipeline should ask synthesis for the [3, H, W, B]
    layout, which only the chain tail emits."""
    return bc_tail_active(resolution, dtype)


def synthesis_apply(params: Dict, wp: torch.Tensor, *, resolution: int,
                    dtype=torch.float32, cb_out: bool = False
                    ) -> torch.Tensor:
    """W+ [B, L, 512] -> image [B, 3, H, W] in [-1, 1] (the trained
    model's range), or [3, H, W, B] with cb_out=True (chain tail only)."""
    channels = RESOLUTIONS_TO_CHANNELS[resolution]
    syn = params["synthesis"]
    wp = wp.to(dtype)
    B = wp.shape[0]
    n_blocks = len(channels) - 1
    bc_first = _bc_first_block(resolution, dtype)
    if cb_out and bc_first > n_blocks:
        raise ValueError("cb_out needs the chain tail (see cb_out_active)")

    p0 = syn["layer0"]
    x = _chw(p0["const"].to(dtype)).expand(B, -1, -1, -1)
    x = _epilogue(p0, x, wp[:, 0], dtype=dtype)

    for block_idx in range(1, min(len(channels), bc_first)):
        x = _remat(lambda x, wp, bi=block_idx: _synthesis_block(
            syn, x, wp, block_idx=bi, dtype=dtype), x, wp)

    if bc_first <= n_blocks:
        return _synthesis_tail_bc(syn, x, wp, bc_first=bc_first,
                                  n_blocks=n_blocks, channels=channels,
                                  dtype=dtype, cb_out=cb_out)

    po = syn[f"output{len(channels) - 2}"]
    scale = 1.0 / math.sqrt(x.shape[1])
    img = nn.conv2d(x, po["conv_weight"].to(dtype), padding=0) * scale
    return img + po["bias"].to(dtype)[None, :, None, None]


def _synthesis_tail_bc(syn: Dict, x: torch.Tensor, wp: torch.Tensor, *,
                       bc_first: int, n_blocks: int, channels, dtype,
                       cb_out: bool = False) -> torch.Tensor:
    """Blocks [bc_first..n_blocks] + the final ToRGB as the chain tail
    (ops/synthesis_tail_bc.py): x enters [H, W, C, B] once and leaves as
    the [3, H, W, B] image."""
    from ..ops import synthesis_tail_bc as bc

    def nb_of(p):
        return (p["noise"] * p["noise_weight"] + p["bias"]).float()

    def styles(p, w_layer, c):
        s0, s1 = _style(p, w_layer, c, dtype=dtype)
        return s0.float() + 1.0, s1.float()

    blocks = []
    for bi in range(bc_first, n_blocks + 1):
        co = channels[bi]
        p_up = syn[f"layer{2 * bi - 2}"]
        p_c = syn[f"layer{2 * bi - 1}"]
        s0p1_u, s1_u = styles(p_up, wp[:, 2 * bi - 2], co)
        s0p1_c, s1_c = styles(p_c, wp[:, 2 * bi - 1], co)
        blk = {
            "k4": p_up["tconv_kernel"],
            "up_nb": nb_of(p_up), "up_s0p1": s0p1_u, "up_s1": s1_u,
            "k": (p_c["conv_weight"] * _wscale(co * 9)).float(),
            "conv_nb": nb_of(p_c), "conv_s0p1": s0p1_c, "conv_s1": s1_c,
        }
        if bi == n_blocks:
            po = syn[f"output{len(channels) - 2}"]
            blk["w_rgb"] = (po["conv_weight"].reshape(co, 3)
                            * (1.0 / math.sqrt(co))).float()
            blk["b_rgb"] = po["bias"]
        blocks.append(blk)

    x_cb = x.permute(2, 3, 1, 0).contiguous()          # -> [H, W, C, B]
    img = bc.tail_chain_bc(x_cb, blocks)
    if cb_out:
        return img                                     # [3, H, W, B]
    return img.permute(3, 0, 1, 2)                     # -> [B, 3, H, W]


def _remat(fn, *args):
    """fn(*args), recomputed in the backward pass when grad is enabled."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _up_half(p: Dict, x: torch.Tensor, w_layer: torch.Tensor, *, li: int,
             dtype) -> torch.Tensor:
    """Up-conv (or upsample + conv) + blur + epilogue of layer li."""
    if is_fused_layer(li):
        x = nn.upconv(x, p["tconv_kernel"].to(dtype))
    elif dtype == torch.bfloat16:
        # upsample + conv3x3 rewritten as one 4-tap stride-2 transposed
        # conv (same math including the padding edges); kernel folded in
        # f32, then cast. f32 keeps the literal op pair.
        k4 = nn.nearest_up_conv3_as_tconv_kernel(
            p["conv_weight"] * _wscale(x.shape[1] * 9))
        x = nn.upconv(x, k4.to(dtype))
    else:
        x = nn.upsample_nearest_2x(x)
        x = nn.conv2d(x, p["conv_weight"].to(dtype)) * _wscale(x.shape[1] * 9)
    return _epilogue(p, nn.blur_3x3(x), w_layer, dtype=dtype)


def _conv_half(p: Dict, x: torch.Tensor, w_layer: torch.Tensor, *,
               dtype) -> torch.Tensor:
    """3x3 conv + epilogue."""
    x = nn.conv2d(x, p["conv_weight"].to(dtype)) * _wscale(x.shape[1] * 9)
    return _epilogue(p, x, w_layer, dtype=dtype)


def _synthesis_block(syn: Dict, x: torch.Tensor, wp: torch.Tensor, *,
                     block_idx: int, dtype) -> torch.Tensor:
    """One resolution block: the up half (absent for the first block,
    whose layer0 is the learned constant), then the conv half; each half
    is its own checkpoint when the block's input is >= 256^2."""
    big = x.shape[2] >= 256

    def call(fn, *args):
        return _remat(fn, *args) if big else fn(*args)

    up, conv = 2 * block_idx - 2, 2 * block_idx - 1
    if up > 0:
        x = call(lambda x, w: _up_half(syn[f"layer{up}"], x, w, li=up,
                                       dtype=dtype), x, wp[:, up])
    return call(lambda x, w: _conv_half(syn[f"layer{conv}"], x, w,
                                        dtype=dtype), x, wp[:, conv])


def postprocess(images: torch.Tensor, min_val: float = -1.0,
                max_val: float = 1.0) -> torch.Tensor:
    """Map to [0, 1] floats (elementwise, so layout-agnostic)."""
    images = (images - min_val) / (max_val - min_val)
    return torch.clamp(images + 0.5 / 255.0, 0.0, 1.0)


def synthesize_from_w(params: Dict, w: torch.Tensor, *, resolution: int,
                      dtype=torch.float32,
                      truncation_psi: Optional[float] = STYLEGAN_TRUNCATION_PSI,
                      truncation_layers: int = STYLEGAN_TRUNCATION_LAYERS,
                      cb_out: bool = False) -> torch.Tensor:
    """truncation -> synthesis -> postprocess: [B, 3, H, W] in [0, 1], or
    [3, H, W, B] with cb_out=True."""
    wp = truncation_apply(params, w, resolution=resolution,
                          truncation_psi=truncation_psi,
                          truncation_layers=truncation_layers)
    img = synthesis_apply(params, wp, resolution=resolution, dtype=dtype,
                          cb_out=cb_out)
    return postprocess(img)


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------

def _fused_tconv_kernel(raw_weight: np.ndarray, scale: float) -> np.ndarray:
    """The effective 4x4 deconv kernel from the raw [3, 3, in, out] weight
    (pad + sum the four shifted copies), wscale folded in, as the HWIO
    kernel of the equivalent forward conv (spatially flipped)."""
    k = np.asarray(raw_weight, np.float32) * scale          # [3,3,in,out]
    k = np.pad(k, ((1, 1), (1, 1), (0, 0), (0, 0)))          # [5,5,in,out]
    k = k[1:, 1:] + k[:-1, 1:] + k[1:, :-1] + k[:-1, :-1]    # [4,4,in,out]
    return k[::-1, ::-1, :, :].copy()


def convert_state_dict_np(sd: Dict[str, np.ndarray], resolution: int
                          ) -> Dict:
    """The reference PyTorch state dict -> the parameter tree, as numpy."""
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    sd = {k: np.asarray(v) for k, v in sd.items()}
    channels = RESOLUTIONS_TO_CHANNELS[resolution]
    params = {"mapping": {}, "truncation": {}, "synthesis": {}}

    for i in range(MAPPING_LAYERS):
        params["mapping"][f"dense{i}"] = {
            "weight": f32(nn.torch_linear_to_io(
                sd[f"mapping.dense{i}.linear.weight"])),
            "bias": f32(sd[f"mapping.dense{i}.wscale.bias"]),
        }
    params["truncation"]["w_avg"] = f32(sd["truncation.w_avg"])

    syn = params["synthesis"]
    for li in range(num_layers(resolution)):
        pre = f"synthesis.layer{li}"
        p = {
            "noise": np.transpose(
                sd[f"{pre}.epilogue.apply_noise.noise"][0], (1, 2, 0)),
            "noise_weight": sd[f"{pre}.epilogue.apply_noise.weight"],
            "bias": sd[f"{pre}.epilogue.bias"],
            "style_weight": nn.torch_linear_to_io(
                sd[f"{pre}.epilogue.style_mod.dense.linear.weight"]),
            "style_bias": sd[f"{pre}.epilogue.style_mod.dense.wscale.bias"],
        }
        if li == 0:
            p["const"] = np.transpose(sd[f"{pre}.first_layer"][0], (1, 2, 0))
        elif li % 2 == 0 and is_fused_layer(li):
            scale = _wscale(channels[li // 2] * 9)
            p["tconv_kernel"] = _fused_tconv_kernel(sd[f"{pre}.weight"], scale)
        else:
            p["conv_weight"] = nn.torch_conv_to_hwio(sd[f"{pre}.conv.weight"])
        syn[f"layer{li}"] = {k: f32(v) for k, v in p.items()}

    for oi in range(len(channels) - 1):
        syn[f"output{oi}"] = {
            "conv_weight": f32(nn.torch_conv_to_hwio(
                sd[f"synthesis.output{oi}.conv.weight"])),
            "bias": f32(sd[f"synthesis.output{oi}.bias"]),
        }
    return params


def convert_torch_state_dict(sd: Dict[str, np.ndarray], resolution: int,
                             device="cuda") -> Dict:
    """The reference PyTorch state dict -> the parameter tree on device."""
    return to_torch(convert_state_dict_np(sd, resolution),
                    resolve_device(device))


def random_torch_style_state_dict(resolution: int, seed: int = 0,
                                  realistic: bool = False
                                  ) -> Dict[str, np.ndarray]:
    """A random state dict with the reference's key naming and shapes, drawn
    in the JAX package's numpy RNG call order (so both packages get the
    same arrays from one seed). realistic=True gives the mapping network
    trained-like equalised-lr magnitudes."""
    rng = np.random.default_rng(seed)

    channels = RESOLUTIONS_TO_CHANNELS[resolution]
    sd = {}
    for i in range(MAPPING_LAYERS):
        mag = 1.0 / MAPPING_LR_MULT if realistic else 1.0
        sd[f"mapping.dense{i}.linear.weight"] = rng.standard_normal(
            (W_DIM, W_DIM)).astype(np.float32) * mag
        sd[f"mapping.dense{i}.wscale.bias"] = rng.standard_normal(
            W_DIM).astype(np.float32) * 0.1
    sd["truncation.w_avg"] = rng.standard_normal(W_DIM).astype(np.float32)

    for li in range(num_layers(resolution)):
        res = 2 ** (li // 2 + 2)
        if li == 0:
            in_ch = out_ch = channels[0]
        elif li % 2 == 0:  # up-conv: channels[i-1] -> channels[i]
            in_ch, out_ch = channels[li // 2], channels[li // 2 + 1]
        else:  # plain conv within the block
            in_ch = out_ch = channels[(li + 1) // 2]
        pre = f"synthesis.layer{li}"
        sd[f"{pre}.epilogue.apply_noise.noise"] = rng.standard_normal(
            (1, 1, res, res)).astype(np.float32)
        sd[f"{pre}.epilogue.apply_noise.weight"] = rng.standard_normal(
            out_ch).astype(np.float32) * 0.1
        sd[f"{pre}.epilogue.bias"] = rng.standard_normal(
            out_ch).astype(np.float32) * 0.1
        sd[f"{pre}.epilogue.style_mod.dense.linear.weight"] = \
            rng.standard_normal((2 * out_ch, W_DIM)).astype(np.float32)
        sd[f"{pre}.epilogue.style_mod.dense.wscale.bias"] = \
            rng.standard_normal(2 * out_ch).astype(np.float32) * 0.1
        if li == 0:
            sd[f"{pre}.first_layer"] = rng.standard_normal(
                (1, channels[0], 4, 4)).astype(np.float32)
        elif li % 2 == 0 and is_fused_layer(li):
            sd[f"{pre}.weight"] = rng.standard_normal(
                (3, 3, in_ch, out_ch)).astype(np.float32)
        else:
            sd[f"{pre}.conv.weight"] = rng.standard_normal(
                (out_ch, in_ch, 3, 3)).astype(np.float32)

    for oi in range(len(channels) - 1):
        ch = channels[oi + 1]
        sd[f"synthesis.output{oi}.conv.weight"] = rng.standard_normal(
            (3, ch, 1, 1)).astype(np.float32)
        sd[f"synthesis.output{oi}.bias"] = rng.standard_normal(
            3).astype(np.float32) * 0.1
    return sd


def random_params(resolution: int, seed: int = 0, realistic: bool = False,
                  device="cuda") -> Dict:
    return convert_torch_state_dict(
        random_torch_style_state_dict(resolution, seed, realistic=realistic),
        resolution, device=device)
