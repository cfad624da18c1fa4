"""ArcFace iresnet (insightface ``recognition/arcface_torch/backbones/
iresnet.py``), eval mode, in plain PyTorch over that file's state-dict
names: conv3x3 -> BN -> PReLU, then IBasicBlocks (BN -> conv3x3 -> BN ->
PReLU -> conv3x3 (stride) -> BN, plus a conv1x1 + BN downsample), BN, the
NCHW flatten, fc and the BatchNorm1d ``features``. 112^2 input, 512-d
output.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import F32, Precision

LAYERS = {"iresnet50": (3, 4, 14, 3)}
PLANES = (64, 128, 256, 512)
BN_EPS = 1e-5


def _bn(sd, pre: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(sd[f"{pre}.running_var"] + BN_EPS) * sd[f"{pre}.weight"]
    return prec.q((x - sd[f"{pre}.running_mean"].reshape(shape)) *
                  inv.reshape(shape) + sd[f"{pre}.bias"].reshape(shape))


def _prelu(sd, pre: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.q(F.prelu(x, sd[f"{pre}.weight"]))


def embed(sd, x: torch.Tensor, arch: str = "iresnet50",
          prec: Precision = F32) -> torch.Tensor:
    """[B, 3, 112, 112] normalised images -> [B, 512] embeddings."""
    x = prec.conv2d(x, sd["conv1.weight"], padding=1)
    x = _prelu(sd, "prelu", _bn(sd, "bn1", x, prec), prec)
    for si, n in enumerate(LAYERS[arch]):
        for bi in range(n):
            pre = f"layer{si + 1}.{bi}"
            stride = 2 if bi == 0 else 1
            out = _bn(sd, f"{pre}.bn1", x, prec)
            out = prec.conv2d(out, sd[f"{pre}.conv1.weight"], padding=1)
            out = _prelu(sd, f"{pre}.prelu", _bn(sd, f"{pre}.bn2", out, prec),
                         prec)
            out = prec.conv2d(out, sd[f"{pre}.conv2.weight"], padding=1,
                              stride=stride)
            out = _bn(sd, f"{pre}.bn3", out, prec)
            if f"{pre}.downsample.0.weight" in sd:
                x = _bn(sd, f"{pre}.downsample.1", prec.conv2d(
                    x, sd[f"{pre}.downsample.0.weight"], stride=stride), prec)
            x = prec.q(out + x)
    x = _bn(sd, "bn2", x, prec).flatten(1)
    x = prec.linear(x, sd["fc.weight"], sd["fc.bias"])
    return _bn(sd, "features", x, prec)


def state_dict_specs(arch: str = "iresnet50", residual_gain: float = 0.3):
    """(name, shape, std, mean) of every tensor, in a fixed order.
    Convolutions He-scaled (std sqrt(2 / fan_in)), BN statistics near the
    identity; the last BN of each residual branch has its scale multiplied
    by ``residual_gain`` so that the 24 residual additions keep the
    activations, and the embeddings, of order one."""
    specs = []

    def conv(name, co, ci, k):
        specs.append((name, (co, ci, k, k), math.sqrt(2.0 / (ci * k * k)),
                      0.0))

    def bn(pre, c, gain=1.0):
        specs.extend([(f"{pre}.weight", (c,), 0.1 * gain, gain),
                      (f"{pre}.bias", (c,), 0.1, 0.0),
                      (f"{pre}.running_mean", (c,), 0.1, 0.0),
                      (f"{pre}.running_var", (c,), 0.1, 1.0)])

    conv("conv1.weight", 64, 3, 3)
    bn("bn1", 64)
    specs.append(("prelu.weight", (64,), 0.05, 0.25))
    inp = 64
    for si, n in enumerate(LAYERS[arch]):
        planes = PLANES[si]
        for bi in range(n):
            pre = f"layer{si + 1}.{bi}"
            ci = inp if bi == 0 else planes
            bn(f"{pre}.bn1", ci)
            conv(f"{pre}.conv1.weight", planes, ci, 3)
            bn(f"{pre}.bn2", planes)
            specs.append((f"{pre}.prelu.weight", (planes,), 0.05, 0.25))
            conv(f"{pre}.conv2.weight", planes, planes, 3)
            bn(f"{pre}.bn3", planes, residual_gain)
            if bi == 0:
                conv(f"{pre}.downsample.0.weight", planes, ci, 1)
                bn(f"{pre}.downsample.1", planes)
        inp = planes
    bn("bn2", 512)
    specs.append(("fc.weight", (512, 512 * 49), math.sqrt(1.0 / (512 * 49)),
                  0.0))
    specs.append(("fc.bias", (512,), 0.1, 0.0))
    bn("features", 512)
    return specs
