"""ProgressiveGAN generator (inference, lod 0), PyTorch port of
certifyingfacerecognition_tpu/models/pggan.py.

Every block is pixel-norm -> (2x nearest upsample) -> conv -> x wscale +
bias -> lrelu; the first block is a 4x4 conv with padding 3 on the 1x1
input, and the ToRGB head has gain 1.0 and no lrelu. The Z code is
normalised onto the sqrt(512) sphere before synthesis. Parameters are
the JAX package's tree (HWIO kernels), activations NCHW. The
convolutions are ordinary cuDNN ones: the JAX package runs them outside
any Pallas kernel.

Spans (utils/profiling.span): ``synthesis.pggan_low`` over the blocks up
to 256^2, ``synthesis.pggan_high`` over the 512^2 and 1024^2 blocks and
the ToRGB head; the Z normalisation and the postprocess fall outside
both.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import nn
# PGGAN's channel table and layer count are StyleGAN's
from .stylegan import RESOLUTIONS_TO_CHANNELS, num_layers, postprocess
from ..utils.device import resolve_device
from ..utils.profiling import span
from ..utils.weights import to_torch

LATENT_DIM = 512
HIGH_MIN_RES = 512           # the blocks from here up are pggan_high's


def preprocess_z(z: torch.Tensor) -> torch.Tensor:
    """Normalise z [B, 512] onto the sqrt(512) sphere."""
    norm = torch.linalg.vector_norm(z, dim=1, keepdim=True)
    return z / norm * math.sqrt(LATENT_DIM)


def _conv_block(p: Dict, x: torch.Tensor, *, padding: int, upsample: bool,
                gain: float, lrelu_act: bool, dtype) -> torch.Tensor:
    x = nn.pixel_norm(x)
    k = p["conv_weight"]
    scale = gain / math.sqrt(k.shape[0] * k.shape[1] * k.shape[2])
    if upsample and dtype == torch.bfloat16:
        # upsample + conv3x3 as one 4-tap stride-2 transposed conv (the
        # same math, padding edges included), the scale folded into the
        # kernel in f32 before the cast
        k4 = nn.nearest_up_conv3_as_tconv_kernel(k * scale)
        x = nn.upconv(x, k4.to(dtype)) + p["bias"].to(dtype)[:, None, None]
        return nn.lrelu(x) if lrelu_act else x
    if upsample:
        x = nn.upsample_nearest_2x(x)
    x = nn.conv2d(x, k.to(dtype), padding=padding)
    x = x * scale + p["bias"].to(dtype)[:, None, None]
    return nn.lrelu(x) if lrelu_act else x


def apply(params: Dict, z: torch.Tensor, *, resolution: int,
          dtype=torch.float32) -> torch.Tensor:
    """z [B, 512] (already normalised) -> image [B, 3, H, W] in [-1, 1]."""
    channels = RESOLUTIONS_TO_CHANNELS[resolution]
    x = z.to(dtype)[:, :, None, None]                  # [B, 512, 1, 1]
    # block bi outputs 2^(bi+1); the first of pggan_high's blocks
    high = min(len(channels), int(math.log2(HIGH_MIN_RES)) - 1)
    with span("synthesis.pggan_low"):
        x = _blocks(params, x, 1, high, dtype)
    with span("synthesis.pggan_high"):
        x = _blocks(params, x, high, len(channels), dtype)
        return _conv_block(params[f"output{len(channels) - 2}"], x,
                           padding=0, upsample=False, gain=1.0,
                           lrelu_act=False, dtype=dtype)


def _blocks(params: Dict, x: torch.Tensor, start: int, stop: int, dtype
            ) -> torch.Tensor:
    """Blocks start..stop-1, each an (up-)conv and a conv."""
    gain = math.sqrt(2.0)
    for block_idx in range(start, stop):
        li = 2 * block_idx - 2
        first = block_idx == 1
        x = _conv_block(params[f"layer{li}"], x, padding=3 if first else 1,
                        upsample=not first, gain=gain, lrelu_act=True,
                        dtype=dtype)
        x = _conv_block(params[f"layer{li + 1}"], x, padding=1,
                        upsample=False, gain=gain, lrelu_act=True,
                        dtype=dtype)
    return x


def synthesize_from_z(params: Dict, z: torch.Tensor, *, resolution: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Z normalisation -> synthesis -> [0, 1] postprocess."""
    return postprocess(apply(params, preprocess_z(z), resolution=resolution,
                             dtype=dtype))


def convert_state_dict_np(sd: Dict[str, np.ndarray], resolution: int
                          ) -> Dict:
    """The reference PGGAN state dict (layerN.conv.weight /
    layerN.wscale.bias, outputN.*) -> the parameter tree, as numpy."""
    def block(prefix):
        return {"conv_weight": np.asarray(nn.torch_conv_to_hwio(
                    sd[f"{prefix}.conv.weight"]), np.float32),
                "bias": np.asarray(sd[f"{prefix}.wscale.bias"], np.float32)}

    params = {f"layer{li}": block(f"layer{li}")
              for li in range(num_layers(resolution))}
    for oi in range(len(RESOLUTIONS_TO_CHANNELS[resolution]) - 1):
        params[f"output{oi}"] = block(f"output{oi}")
    return params


def convert_torch_state_dict(sd: Dict[str, np.ndarray], resolution: int,
                             device="cuda") -> Dict:
    """The reference PGGAN state dict -> the parameter tree on device."""
    return to_torch(convert_state_dict_np(sd, resolution),
                    resolve_device(device))


def random_torch_style_state_dict(resolution: int, seed: int = 0
                                  ) -> Dict[str, np.ndarray]:
    """A random state dict with the reference's key naming and shapes, drawn
    in the JAX package's numpy RNG call order (both packages get the same
    arrays from one seed)."""
    rng = np.random.default_rng(seed)
    channels = RESOLUTIONS_TO_CHANNELS[resolution]
    sd: Dict[str, np.ndarray] = {}
    for li in range(num_layers(resolution)):
        if li == 0:
            in_ch, out_ch, k = channels[0], channels[1], 4
        elif li % 2 == 0:
            in_ch, out_ch, k = channels[li // 2], channels[li // 2 + 1], 3
        else:
            in_ch = out_ch = channels[(li + 1) // 2]
            k = 3
        sd[f"layer{li}.conv.weight"] = (
            rng.standard_normal((out_ch, in_ch, k, k)) * 0.5
        ).astype(np.float32)
        sd[f"layer{li}.wscale.bias"] = (
            rng.standard_normal(out_ch) * 0.1).astype(np.float32)
    for oi in range(len(channels) - 1):
        ch = channels[oi + 1]
        sd[f"output{oi}.conv.weight"] = (
            rng.standard_normal((3, ch, 1, 1)) * 0.5).astype(np.float32)
        sd[f"output{oi}.wscale.bias"] = (
            rng.standard_normal(3) * 0.1).astype(np.float32)
    return sd


def random_params(resolution: int, seed: int = 0, device="cuda") -> Dict:
    return convert_torch_state_dict(
        random_torch_style_state_dict(resolution, seed), resolution,
        device=device)
