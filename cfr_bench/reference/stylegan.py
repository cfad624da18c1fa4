"""StyleGAN (Karras et al., CVPR 2019) synthesis network, written from
InterFaceGAN's ``stylegan_generator`` model in plain PyTorch, float32 and
NCHW, over that model's state-dict names:

    w -> truncation toward w_avg (psi 0.7 on the first 8 layers) ->
    const 4x4 -> per layer: [nearest 2x + conv3x3 | fused 4x4 stride-2
    transposed conv from 128^2 up] + blur, or conv3x3; then noise, bias,
    leaky ReLU 0.2, instance norm, style modulation -> 1x1 ToRGB ->
    [0, 1] images.

Weights are scaled at run time (equalised learning rate): conv gain
sqrt(2) / sqrt(fan_in), style dense and ToRGB gain 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import F32, Precision

W_DIM = 512
MAPPING_LAYERS = 8
TRUNCATION_PSI = 0.7
TRUNCATION_LAYERS = 8
FUSED_MIN_RES = 128


def channels_at(res: int) -> int:
    """Feature maps of the layers at resolution ``res``."""
    return min(512, 16384 // res)


def num_layers(resolution: int) -> int:
    return 2 * int(math.log2(resolution)) - 2


def layer_res(li: int) -> int:
    return 2 ** (li // 2 + 2)


def truncate(sd, w: torch.Tensor, resolution: int) -> torch.Tensor:
    """W [B, 512] -> W+ [B, L, 512]."""
    n = num_layers(resolution)
    coefs = torch.ones((1, n, 1), dtype=w.dtype, device=w.device)
    coefs[:, :TRUNCATION_LAYERS] = TRUNCATION_PSI
    w_avg = sd["truncation.w_avg"].reshape(1, 1, W_DIM)
    return w_avg + (w[:, None, :] - w_avg) * coefs


def _blur(x: torch.Tensor) -> torch.Tensor:
    k1 = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype, device=x.device)
    k = (torch.outer(k1, k1) / 16.0).expand(x.shape[1], 1, 3, 3)
    return F.conv2d(x, k, padding=1, groups=x.shape[1])


def _epilogue(sd, pre: str, x, w_layer, prec: Precision):
    c, q = x.shape[1], prec.q
    x = q(x + sd[f"{pre}.epilogue.apply_noise.noise"] *
          sd[f"{pre}.epilogue.apply_noise.weight"].reshape(1, c, 1, 1))
    x = q(x + sd[f"{pre}.epilogue.bias"].reshape(1, c, 1, 1))
    x = q(F.leaky_relu(x, 0.2))
    x = x - x.mean((2, 3), keepdim=True)
    x = q(x * torch.rsqrt((x * x).mean((2, 3), keepdim=True) + 1e-8))
    style = prec.linear(w_layer, sd[f"{pre}.epilogue.style_mod.dense."
                                    "linear.weight"]) / math.sqrt(W_DIM)
    style = style + sd[f"{pre}.epilogue.style_mod.dense.wscale.bias"]
    return q(x * (style[:, :c, None, None] + 1.0) + style[:, c:, None, None])


def _layer(sd, li: int, x, w_layer, prec: Precision):
    pre = f"synthesis.layer{li}"
    if li % 2 == 1:                                    # conv 3x3
        w = sd[f"{pre}.conv.weight"]
        x = prec.conv2d(x, w, padding=1) * (math.sqrt(2.0 / (w.shape[1] * 9)))
    elif layer_res(li) >= FUSED_MIN_RES:               # fused up-conv
        raw = sd[f"{pre}.weight"]                      # [3, 3, in, out]
        k = raw * math.sqrt(2.0 / (raw.shape[2] * 9))
        k = F.pad(k, (0, 0, 0, 0, 1, 1, 1, 1))
        k = k[1:, 1:] + k[:-1, 1:] + k[1:, :-1] + k[:-1, :-1]
        x = prec.q(_blur(prec.conv_transpose2d(x, k.permute(2, 3, 0, 1))))
    else:                                              # nearest 2x + conv
        w = sd[f"{pre}.conv.weight"]
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = prec.conv2d(x, w, padding=1) * math.sqrt(2.0 / (w.shape[1] * 9))
        x = prec.q(_blur(x))
    return _epilogue(sd, pre, x, w_layer, prec)


def synthesis(sd, wp: torch.Tensor, resolution: int,
              prec: Precision = F32) -> torch.Tensor:
    """W+ [B, L, 512] -> images [B, 3, R, R] in [-1, 1]."""
    const = sd["synthesis.layer0.first_layer"]
    x = const.expand(wp.shape[0], -1, -1, -1)
    x = _epilogue(sd, "synthesis.layer0", x, wp[:, 0], prec)
    for li in range(1, num_layers(resolution)):
        x = _layer(sd, li, x, wp[:, li], prec)
    oi = int(math.log2(resolution)) - 2
    w = sd[f"synthesis.output{oi}.conv.weight"]
    img = prec.conv2d(x, w) / math.sqrt(w.shape[1])
    return img + sd[f"synthesis.output{oi}.bias"].reshape(1, 3, 1, 1)


def synthesize(sd, w: torch.Tensor, resolution: int,
               prec: Precision = F32) -> torch.Tensor:
    """W [B, 512] -> [B, 3, R, R] images in [0, 1] (InterFaceGAN's
    postprocess without the uint8 rounding)."""
    img = synthesis(sd, truncate(sd, w, resolution), resolution, prec)
    return torch.clamp((img + 1.0) / 2.0 + 0.5 / 255.0, 0.0, 1.0)


def state_dict_specs(resolution: int):
    """(name, shape, std, mean) of every tensor of the state dict at
    ``resolution``, in a fixed order (the weights are random: the mapping
    network's entries are there for the checkpoint's layout)."""
    specs = []
    for i in range(MAPPING_LAYERS):
        specs.append((f"mapping.dense{i}.linear.weight", (W_DIM, W_DIM),
                      1.0, 0.0))
        specs.append((f"mapping.dense{i}.wscale.bias", (W_DIM,), 0.1, 0.0))
    specs.append(("truncation.w_avg", (W_DIM,), 1.0, 0.0))
    for li in range(num_layers(resolution)):
        res = layer_res(li)
        co = channels_at(res)
        ci = channels_at(res // 2) if li % 2 == 0 and li else co
        pre = f"synthesis.layer{li}"
        specs += [
            (f"{pre}.epilogue.apply_noise.noise", (1, 1, res, res), 1.0, 0.0),
            (f"{pre}.epilogue.apply_noise.weight", (co,), 0.1, 0.0),
            (f"{pre}.epilogue.bias", (co,), 0.1, 0.0),
            (f"{pre}.epilogue.style_mod.dense.linear.weight", (2 * co, W_DIM),
             1.0, 0.0),
            (f"{pre}.epilogue.style_mod.dense.wscale.bias", (2 * co,), 0.1,
             0.0)]
        if li == 0:
            specs.append((f"{pre}.first_layer", (1, co, 4, 4), 1.0, 0.0))
        elif li % 2 == 0 and res >= FUSED_MIN_RES:
            specs.append((f"{pre}.weight", (3, 3, ci, co), 1.0, 0.0))
        else:
            specs.append((f"{pre}.conv.weight", (co, ci, 3, 3), 1.0, 0.0))
    for oi in range(int(math.log2(resolution)) - 1):
        ch = channels_at(2 ** (oi + 2))
        specs.append((f"synthesis.output{oi}.conv.weight", (3, ch, 1, 1),
                      1.0, 0.0))
        specs.append((f"synthesis.output{oi}.bias", (3,), 0.1, 0.0))
    return specs
