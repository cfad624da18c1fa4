"""ArcFace iresnet backbone (inference), PyTorch port of
certifyingfacerecognition_tpu/models/iresnet.py.

All BatchNorms are folded into per-channel (scale, shift) pairs at weight
conversion (eval-mode running stats). Block structure: BN -> conv3x3 ->
BN -> PReLU -> conv3x3(stride) -> BN, plus a conv1x1+BN downsample on the
residual path. Activations NCHW; kernels HWIO as in the JAX package's
parameter tree.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import nn
from ..utils.device import resolve_device
from ..utils.weights import to_torch

LAYER_COUNTS = {
    "iresnet18": [2, 2, 2, 2],
    "iresnet34": [3, 4, 6, 3],
    "iresnet50": [3, 4, 14, 3],
    "iresnet100": [3, 13, 30, 3],
    "iresnet200": [6, 26, 60, 6],
}
STAGE_PLANES = [64, 128, 256, 512]
BN_EPS = 1e-5
FC_SCALE = 7 * 7  # 112x112 input, four stride-2 stages
NUM_FEATURES = 512


def _bn(x, p, dtype):
    return nn.affine_channels(x, p["scale"].to(dtype), p["shift"].to(dtype))


def _block_apply(p: Dict, x: torch.Tensor, stride: int, *, dtype
                 ) -> torch.Tensor:
    out = _bn(x, p["bn1"], dtype)
    out = nn.conv2d(out, p["conv1"].to(dtype))
    out = _bn(out, p["bn2"], dtype)
    out = nn.prelu(out, p["prelu"].to(dtype))
    out = nn.conv2d(out, p["conv2"].to(dtype), stride=stride)
    out = _bn(out, p["bn3"], dtype)
    identity = x
    if "downsample" in p:
        identity = nn.conv2d(x, p["downsample"]["conv"].to(dtype),
                             padding=0, stride=stride)
        identity = _bn(identity, p["downsample"]["bn"], dtype)
    return out + identity


def apply(params: Dict, x: torch.Tensor, *, dtype=torch.float32
          ) -> torch.Tensor:
    """x: [B, 3, 112, 112] normalised images -> [B, 512] embeddings."""
    x = nn.conv2d(x.to(dtype), params["conv1"].to(dtype))
    x = _bn(x, params["bn1"], dtype)
    x = nn.prelu(x, params["prelu"].to(dtype))
    for blocks in params["stages"]:
        for bi, bp in enumerate(blocks):
            x = _block_apply(bp, x, stride=2 if bi == 0 else 1, dtype=dtype)
    x = _bn(x, params["bn2"], dtype)
    # the fc weight is stored permuted for an NHWC flatten (as the JAX
    # package flattens), so flatten in that order
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()
    x = x @ params["fc"]["weight"] + params["fc"]["bias"]
    return nn.affine_channels(x, params["features"]["scale"],
                              params["features"]["shift"])


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------

def _fold_bn(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    scale, shift = nn.fold_batchnorm(
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"],
        sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"], BN_EPS)
    return {"scale": scale, "shift": shift}


def convert_state_dict_np(sd: Dict[str, np.ndarray],
                          arch: str = "iresnet50") -> Dict:
    """The reference checkpoint (backbone.pth naming) -> the folded
    parameter tree, as numpy."""
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params = {
        "conv1": f32(nn.torch_conv_to_hwio(sd["conv1.weight"])),
        "bn1": _fold_bn(sd, "bn1"),
        "prelu": f32(sd["prelu.weight"]),
        "stages": [],
    }
    for si, n_blocks in enumerate(LAYER_COUNTS[arch]):
        stage = []
        for bi in range(n_blocks):
            pre = f"layer{si + 1}.{bi}"
            p = {
                "bn1": _fold_bn(sd, f"{pre}.bn1"),
                "conv1": f32(nn.torch_conv_to_hwio(sd[f"{pre}.conv1.weight"])),
                "bn2": _fold_bn(sd, f"{pre}.bn2"),
                "prelu": f32(sd[f"{pre}.prelu.weight"]),
                "conv2": f32(nn.torch_conv_to_hwio(sd[f"{pre}.conv2.weight"])),
                "bn3": _fold_bn(sd, f"{pre}.bn3"),
            }
            if f"{pre}.downsample.0.weight" in sd:
                p["downsample"] = {
                    "conv": f32(nn.torch_conv_to_hwio(
                        sd[f"{pre}.downsample.0.weight"])),
                    "bn": _fold_bn(sd, f"{pre}.downsample.1"),
                }
            stage.append(p)
        params["stages"].append(stage)

    params["bn2"] = _fold_bn(sd, "bn2")
    # torch flattens NCHW, the tree's fc consumes the NHWC flatten order:
    # [out, C*H*W] -> [out, C, H, W] -> [out, H, W, C] -> [H*W*C, out]
    fc_w = sd["fc.weight"].reshape(NUM_FEATURES, 512, 7, 7)
    fc_w = np.transpose(fc_w, (0, 2, 3, 1)).reshape(NUM_FEATURES, -1)
    params["fc"] = {"weight": f32(fc_w.T), "bias": f32(sd["fc.bias"])}
    params["features"] = _fold_bn(sd, "features")
    return params


def convert_torch_state_dict(sd: Dict[str, np.ndarray],
                             arch: str = "iresnet50", device="cuda") -> Dict:
    return to_torch(convert_state_dict_np(sd, arch), resolve_device(device))


def random_torch_style_state_dict(arch: str = "iresnet50", seed: int = 0,
                                  realistic: bool = False
                                  ) -> Dict[str, np.ndarray]:
    """Random state dict with the reference naming/shapes, drawn in the JAX
    package's numpy RNG call order. realistic=True: He-scaled convs and
    benign BN statistics (discriminative embeddings)."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.2):
        if realistic and len(shape) == 4:             # conv OIHW: He init
            s = math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def bn(prefix, c, sd):
        if realistic:
            sd[f"{prefix}.weight"] = w(c, s=0.1) + 1.0
            sd[f"{prefix}.bias"] = w(c, s=0.1)
            sd[f"{prefix}.running_mean"] = w(c, s=0.1)
            sd[f"{prefix}.running_var"] = np.abs(w(c, s=0.1)) + 1.0
            return
        sd[f"{prefix}.weight"] = w(c, s=0.3) + 1.0
        sd[f"{prefix}.bias"] = w(c)
        sd[f"{prefix}.running_mean"] = w(c)
        sd[f"{prefix}.running_var"] = np.abs(w(c)) + 0.5

    sd: Dict[str, np.ndarray] = {}
    sd["conv1.weight"] = w(64, 3, 3, 3)
    bn("bn1", 64, sd)
    sd["prelu.weight"] = np.abs(w(64)) + 0.1

    inplanes = 64
    for si, n_blocks in enumerate(LAYER_COUNTS[arch]):
        planes = STAGE_PLANES[si]
        for bi in range(n_blocks):
            pre = f"layer{si + 1}.{bi}"
            inp = inplanes if bi == 0 else planes
            bn(f"{pre}.bn1", inp, sd)
            sd[f"{pre}.conv1.weight"] = w(planes, inp, 3, 3)
            bn(f"{pre}.bn2", planes, sd)
            sd[f"{pre}.prelu.weight"] = np.abs(w(planes)) + 0.1
            sd[f"{pre}.conv2.weight"] = w(planes, planes, 3, 3)
            bn(f"{pre}.bn3", planes, sd)
            if bi == 0:  # stride-2 downsample on every stage
                sd[f"{pre}.downsample.0.weight"] = w(planes, inp, 1, 1)
                bn(f"{pre}.downsample.1", planes, sd)
        inplanes = planes

    bn("bn2", 512, sd)
    sd["fc.weight"] = w(NUM_FEATURES, 512 * FC_SCALE,
                        s=math.sqrt(1.0 / (512 * FC_SCALE))
                        if realistic else 0.02)
    sd["fc.bias"] = w(NUM_FEATURES)
    bn("features", NUM_FEATURES, sd)
    return sd
