"""ProgressiveGAN (Karras et al., ICLR 2018) generator, written from the
paper's equations and InterFaceGAN's ``pggan_generator_model`` in plain
PyTorch, float32 (TF32 off: ``precision.exact_f32``, which the checks
call first) and NCHW, over that model's state-dict names
(``layerN.conv.weight``, ``layerN.wscale.bias``, ``outputN.*``):

    z -> onto the sqrt(512) sphere -> [B, 512, 1, 1] -> 18 convolutions,
    each: pixel norm -> (nearest 2x) -> conv -> x wscale + bias -> leaky
    ReLU 0.2; the first a 4x4 conv with padding 3 on the 1x1 input, then
    3x3 convs with padding 1, two a resolution, the first of each pair
    after the upsample -> pixel norm -> 1x1 ToRGB at gain 1, no leaky
    ReLU -> [0, 1] images.

Weights are scaled at run time (equalised learning rate): wscale =
gain / sqrt(fan_in), gain sqrt(2) for the convolutions and 1 for ToRGB.
Channels are 512 from 4^2 to 32^2, then halve at each resolution to 16
at 1024^2. Departures from the trained model: lod 0 only, so there is
no fade-in between ToRGB heads and only the last head runs (the others
are in the state dict for the checkpoint's layout).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import F32, Precision

LATENT_DIM = 512
# spreads of the random weights (the configuration's ``assumed``): the
# convolutions as equalised learning rate stores them, small biases
WEIGHT_STD, BIAS_STD = 1.0, 0.1


def channels_at(res: int) -> int:
    """Feature maps of the convolutions at resolution ``res``."""
    return min(512, 16384 // res)


def num_layers(resolution: int) -> int:
    """Convolutions before the ToRGB head: two a resolution from 4^2."""
    return 2 * int(math.log2(resolution)) - 2


def layer_shape(li: int):
    """(in channels, out channels, kernel size, output resolution) of
    convolution ``li``."""
    res = 2 ** (li // 2 + 2)
    if li == 0:
        return LATENT_DIM, channels_at(4), 4, 4
    if li % 2 == 0:
        return channels_at(res // 2), channels_at(res), 3, res
    return channels_at(res), channels_at(res), 3, res


def normalize_z(z: torch.Tensor) -> torch.Tensor:
    """z [B, 512] onto the sqrt(512) sphere."""
    return z / z.norm(dim=1, keepdim=True) * math.sqrt(LATENT_DIM)


def _block(sd, pre: str, x, padding: int, upsample: bool, gain: float,
           lrelu: bool, prec: Precision):
    q = prec.q
    x = q(x * torch.rsqrt((x * x).mean(1, keepdim=True) + 1e-8))
    if upsample:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
    w = sd[f"{pre}.conv.weight"]                      # [out, in, k, k]
    x = prec.conv2d(x, w, padding=padding) * (gain / math.sqrt(w[0].numel()))
    x = q(x + sd[f"{pre}.wscale.bias"].reshape(1, -1, 1, 1))
    return q(F.leaky_relu(x, 0.2)) if lrelu else x


def synthesis(sd, z: torch.Tensor, resolution: int,
              prec: Precision = F32) -> torch.Tensor:
    """Normalised z [B, 512] -> images [B, 3, R, R] in [-1, 1]."""
    x = z[:, :, None, None]
    gain = math.sqrt(2.0)
    for li in range(num_layers(resolution)):
        x = _block(sd, f"layer{li}", x, padding=3 if li == 0 else 1,
                   upsample=li > 0 and li % 2 == 0, gain=gain, lrelu=True,
                   prec=prec)
    oi = int(math.log2(resolution)) - 2
    return _block(sd, f"output{oi}", x, padding=0, upsample=False, gain=1.0,
                  lrelu=False, prec=prec)


def synthesize(sd, z: torch.Tensor, resolution: int,
               prec: Precision = F32) -> torch.Tensor:
    """Z [B, 512] -> [B, 3, R, R] images in [0, 1] (InterFaceGAN's
    postprocess without the uint8 rounding)."""
    img = synthesis(sd, normalize_z(z), resolution, prec)
    return torch.clamp((img + 1.0) / 2.0 + 0.5 / 255.0, 0.0, 1.0)


def state_dict_specs(resolution: int):
    """(name, shape, std, mean) of every tensor of the state dict at
    ``resolution``, in a fixed order: every convolution, then every
    resolution's ToRGB head."""
    specs = []
    for li in range(num_layers(resolution)):
        ci, co, k, _ = layer_shape(li)
        specs.append((f"layer{li}.conv.weight", (co, ci, k, k), WEIGHT_STD,
                      0.0))
        specs.append((f"layer{li}.wscale.bias", (co,), BIAS_STD, 0.0))
    for oi in range(int(math.log2(resolution)) - 1):
        ch = channels_at(2 ** (oi + 2))
        specs.append((f"output{oi}.conv.weight", (3, ch, 1, 1), WEIGHT_STD,
                      0.0))
        specs.append((f"output{oi}.wscale.bias", (3,), BIAS_STD, 0.0))
    return specs
