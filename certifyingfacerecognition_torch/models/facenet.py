"""FaceNet (InceptionResnetV1) embedding network (inference), PyTorch port
of certifyingfacerecognition_tpu/models/facenet.py.

The public InceptionResnetV1 architecture with facenet_pytorch's
state-dict naming: the conv2d_1a..conv2d_4b stem, repeat_1 / mixed_6a /
repeat_2 / mixed_7a / repeat_3 / block8 inception-resnet blocks, the
last_linear + last_bn head and the L2-normalised 512-d embedding. Every
BatchNorm (eps 1e-3) is folded into a per-channel (scale, shift) at
conversion. Activations NCHW; kernels HWIO as in the JAX package's
parameter tree, so a tree carries across unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import nn
from ..utils.device import resolve_device
from ..utils.weights import to_torch

BN_EPS = 1e-3
_SAME3 = ((1, 1), (1, 1))


def _basic_conv(p: Dict, x, *, stride=1, padding=0, dtype):
    """conv (no bias) -> folded BN -> relu."""
    x = nn.conv2d(x, p["kernel"].to(dtype), padding=padding, stride=stride)
    x = nn.affine_channels(x, p["bn"]["scale"].to(dtype),
                           p["bn"]["shift"].to(dtype))
    return torch.relu(x)


def _residual_up(p: Dict, branches, dtype):
    """The 1x1 conv (with bias) over the concatenated branches."""
    up = torch.cat(branches, dim=1)
    return nn.conv2d(up, p["conv2d"]["kernel"].to(dtype), padding=0) + \
        p["conv2d"]["bias"].to(dtype)[:, None, None]


def _block35(p: Dict, x, *, dtype):
    b0 = _basic_conv(p["branch0"], x, dtype=dtype)
    b1 = _basic_conv(p["branch1"][0], x, dtype=dtype)
    b1 = _basic_conv(p["branch1"][1], b1, padding=_SAME3, dtype=dtype)
    b2 = _basic_conv(p["branch2"][0], x, dtype=dtype)
    b2 = _basic_conv(p["branch2"][1], b2, padding=_SAME3, dtype=dtype)
    b2 = _basic_conv(p["branch2"][2], b2, padding=_SAME3, dtype=dtype)
    return torch.relu(x + 0.17 * _residual_up(p, [b0, b1, b2], dtype))


def _mixed_6a(p: Dict, x, *, dtype):
    b0 = _basic_conv(p["branch0"], x, stride=2, dtype=dtype)
    b1 = _basic_conv(p["branch1"][0], x, dtype=dtype)
    b1 = _basic_conv(p["branch1"][1], b1, padding=_SAME3, dtype=dtype)
    b1 = _basic_conv(p["branch1"][2], b1, stride=2, dtype=dtype)
    return torch.cat([b0, b1, nn.max_pool_3x3_s2(x)], dim=1)


def _block17(p: Dict, x, *, dtype):
    b0 = _basic_conv(p["branch0"], x, dtype=dtype)
    b1 = _basic_conv(p["branch1"][0], x, dtype=dtype)
    b1 = _basic_conv(p["branch1"][1], b1, padding=((0, 0), (3, 3)),
                     dtype=dtype)
    b1 = _basic_conv(p["branch1"][2], b1, padding=((3, 3), (0, 0)),
                     dtype=dtype)
    return torch.relu(x + 0.10 * _residual_up(p, [b0, b1], dtype))


def _mixed_7a(p: Dict, x, *, dtype):
    b0 = _basic_conv(p["branch0"][0], x, dtype=dtype)
    b0 = _basic_conv(p["branch0"][1], b0, stride=2, dtype=dtype)
    b1 = _basic_conv(p["branch1"][0], x, dtype=dtype)
    b1 = _basic_conv(p["branch1"][1], b1, stride=2, dtype=dtype)
    b2 = _basic_conv(p["branch2"][0], x, dtype=dtype)
    b2 = _basic_conv(p["branch2"][1], b2, padding=_SAME3, dtype=dtype)
    b2 = _basic_conv(p["branch2"][2], b2, stride=2, dtype=dtype)
    return torch.cat([b0, b1, b2, nn.max_pool_3x3_s2(x)], dim=1)


def _block8(p: Dict, x, *, scale, relu, dtype):
    b0 = _basic_conv(p["branch0"], x, dtype=dtype)
    b1 = _basic_conv(p["branch1"][0], x, dtype=dtype)
    b1 = _basic_conv(p["branch1"][1], b1, padding=((0, 0), (1, 1)),
                     dtype=dtype)
    b1 = _basic_conv(p["branch1"][2], b1, padding=((1, 1), (0, 0)),
                     dtype=dtype)
    out = x + scale * _residual_up(p, [b0, b1], dtype)
    return torch.relu(out) if relu else out


def apply(params: Dict, x: torch.Tensor, *, dtype=torch.float32
          ) -> torch.Tensor:
    """x: [B, 3, 160, 160] normalised images -> [B, 512] L2-normalised
    embeddings (eval mode; dropout is the identity)."""
    x = x.to(dtype)
    x = _basic_conv(params["conv2d_1a"], x, stride=2, dtype=dtype)
    x = _basic_conv(params["conv2d_2a"], x, dtype=dtype)
    x = _basic_conv(params["conv2d_2b"], x, padding=_SAME3, dtype=dtype)
    x = nn.max_pool_3x3_s2(x)
    x = _basic_conv(params["conv2d_3b"], x, dtype=dtype)
    x = _basic_conv(params["conv2d_4a"], x, dtype=dtype)
    x = _basic_conv(params["conv2d_4b"], x, stride=2, dtype=dtype)
    for p in params["repeat_1"]:
        x = _block35(p, x, dtype=dtype)
    x = _mixed_6a(params["mixed_6a"], x, dtype=dtype)
    for p in params["repeat_2"]:
        x = _block17(p, x, dtype=dtype)
    x = _mixed_7a(params["mixed_7a"], x, dtype=dtype)
    for p in params["repeat_3"]:
        x = _block8(p, x, scale=0.20, relu=True, dtype=dtype)
    x = _block8(params["block8"], x, scale=1.0, relu=False, dtype=dtype)
    x = x.mean((2, 3)).float()                 # AdaptiveAvgPool2d(1)
    x = x @ params["last_linear"]["weight"]
    x = nn.affine_channels(x, params["last_bn"]["scale"],
                           params["last_bn"]["shift"])
    # F.normalize(x, p=2, dim=1)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=1e-12)


# ---------------------------------------------------------------------------
# Weight conversion (facenet_pytorch state-dict naming)
# ---------------------------------------------------------------------------

def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _conv_bn(sd, prefix) -> Dict:
    scale, shift = nn.fold_batchnorm(
        sd[f"{prefix}.bn.weight"], sd[f"{prefix}.bn.bias"],
        sd[f"{prefix}.bn.running_mean"], sd[f"{prefix}.bn.running_var"],
        BN_EPS)
    return {"kernel": _f32(nn.torch_conv_to_hwio(sd[f"{prefix}.conv.weight"])),
            "bn": {"scale": scale, "shift": shift}}


def _plain_conv(sd, prefix) -> Dict:
    return {"kernel": _f32(nn.torch_conv_to_hwio(sd[f"{prefix}.weight"])),
            "bias": _f32(sd[f"{prefix}.bias"])}


def _branch(sd, prefix, n):
    if n == 1:
        return _conv_bn(sd, prefix)
    return [_conv_bn(sd, f"{prefix}.{i}") for i in range(n)]


def _residual_block(sd, prefix, n_branch1, n_branch2=0) -> Dict:
    p = {"branch0": _branch(sd, f"{prefix}.branch0", 1),
         "branch1": _branch(sd, f"{prefix}.branch1", n_branch1)}
    if n_branch2:
        p["branch2"] = _branch(sd, f"{prefix}.branch2", n_branch2)
    p["conv2d"] = _plain_conv(sd, f"{prefix}.conv2d")
    return p


def convert_state_dict_np(sd: Dict[str, np.ndarray]) -> Dict:
    """A facenet_pytorch state dict -> the folded parameter tree, as
    numpy (the JAX package's tree: HWIO kernels, [in, out] last_linear)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: Dict = {name: _conv_bn(sd, name) for name in (
        "conv2d_1a", "conv2d_2a", "conv2d_2b", "conv2d_3b", "conv2d_4a",
        "conv2d_4b")}
    params["repeat_1"] = [_residual_block(sd, f"repeat_1.{i}", 2, 3)
                          for i in range(5)]
    params["mixed_6a"] = {"branch0": _branch(sd, "mixed_6a.branch0", 1),
                          "branch1": _branch(sd, "mixed_6a.branch1", 3)}
    params["repeat_2"] = [_residual_block(sd, f"repeat_2.{i}", 3)
                          for i in range(10)]
    params["mixed_7a"] = {"branch0": _branch(sd, "mixed_7a.branch0", 2),
                          "branch1": _branch(sd, "mixed_7a.branch1", 2),
                          "branch2": _branch(sd, "mixed_7a.branch2", 3)}
    params["repeat_3"] = [_residual_block(sd, f"repeat_3.{i}", 3)
                          for i in range(5)]
    params["block8"] = _residual_block(sd, "block8", 3)
    params["last_linear"] = {
        "weight": _f32(nn.torch_linear_to_io(sd["last_linear.weight"]))}
    scale, shift = nn.fold_batchnorm(
        sd["last_bn.weight"], sd["last_bn.bias"], sd["last_bn.running_mean"],
        sd["last_bn.running_var"], BN_EPS)
    params["last_bn"] = {"scale": scale, "shift": shift}
    return params


def convert_torch_state_dict(sd: Dict[str, np.ndarray], device="cuda"
                             ) -> Dict:
    return to_torch(convert_state_dict_np(sd), resolve_device(device))


def random_torch_style_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random state dict with facenet_pytorch's naming and shapes, drawn
    in the JAX package's numpy RNG call order (the same seed gives the
    same arrays in both packages)."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def conv_bn(prefix, cin, cout, kh, kw):
        sd[f"{prefix}.conv.weight"] = (
            rng.standard_normal((cout, cin, kh, kw)) * 0.08).astype(np.float32)
        sd[f"{prefix}.bn.weight"] = (
            rng.standard_normal(cout) * 0.2 + 1).astype(np.float32)
        sd[f"{prefix}.bn.bias"] = (
            rng.standard_normal(cout) * 0.1).astype(np.float32)
        sd[f"{prefix}.bn.running_mean"] = (
            rng.standard_normal(cout) * 0.1).astype(np.float32)
        sd[f"{prefix}.bn.running_var"] = (
            np.abs(rng.standard_normal(cout)) * 0.3 + 0.7).astype(np.float32)

    def plain(prefix, cin, cout):
        sd[f"{prefix}.weight"] = (
            rng.standard_normal((cout, cin, 1, 1)) * 0.08).astype(np.float32)
        sd[f"{prefix}.bias"] = (
            rng.standard_normal(cout) * 0.1).astype(np.float32)

    conv_bn("conv2d_1a", 3, 32, 3, 3)
    conv_bn("conv2d_2a", 32, 32, 3, 3)
    conv_bn("conv2d_2b", 32, 64, 3, 3)
    conv_bn("conv2d_3b", 64, 80, 1, 1)
    conv_bn("conv2d_4a", 80, 192, 3, 3)
    conv_bn("conv2d_4b", 192, 256, 3, 3)
    for i in range(5):
        conv_bn(f"repeat_1.{i}.branch0", 256, 32, 1, 1)
        conv_bn(f"repeat_1.{i}.branch1.0", 256, 32, 1, 1)
        conv_bn(f"repeat_1.{i}.branch1.1", 32, 32, 3, 3)
        conv_bn(f"repeat_1.{i}.branch2.0", 256, 32, 1, 1)
        conv_bn(f"repeat_1.{i}.branch2.1", 32, 32, 3, 3)
        conv_bn(f"repeat_1.{i}.branch2.2", 32, 32, 3, 3)
        plain(f"repeat_1.{i}.conv2d", 96, 256)
    conv_bn("mixed_6a.branch0", 256, 384, 3, 3)
    conv_bn("mixed_6a.branch1.0", 256, 192, 1, 1)
    conv_bn("mixed_6a.branch1.1", 192, 192, 3, 3)
    conv_bn("mixed_6a.branch1.2", 192, 256, 3, 3)
    for i in range(10):
        conv_bn(f"repeat_2.{i}.branch0", 896, 128, 1, 1)
        conv_bn(f"repeat_2.{i}.branch1.0", 896, 128, 1, 1)
        conv_bn(f"repeat_2.{i}.branch1.1", 128, 128, 1, 7)
        conv_bn(f"repeat_2.{i}.branch1.2", 128, 128, 7, 1)
        plain(f"repeat_2.{i}.conv2d", 256, 896)
    conv_bn("mixed_7a.branch0.0", 896, 256, 1, 1)
    conv_bn("mixed_7a.branch0.1", 256, 384, 3, 3)
    conv_bn("mixed_7a.branch1.0", 896, 256, 1, 1)
    conv_bn("mixed_7a.branch1.1", 256, 256, 3, 3)
    conv_bn("mixed_7a.branch2.0", 896, 256, 1, 1)
    conv_bn("mixed_7a.branch2.1", 256, 256, 3, 3)
    conv_bn("mixed_7a.branch2.2", 256, 256, 3, 3)
    for prefix in [f"repeat_3.{i}" for i in range(5)] + ["block8"]:
        conv_bn(f"{prefix}.branch0", 1792, 192, 1, 1)
        conv_bn(f"{prefix}.branch1.0", 1792, 192, 1, 1)
        conv_bn(f"{prefix}.branch1.1", 192, 192, 1, 3)
        conv_bn(f"{prefix}.branch1.2", 192, 192, 3, 1)
        plain(f"{prefix}.conv2d", 384, 1792)
    sd["last_linear.weight"] = (
        rng.standard_normal((512, 1792)) * 0.03).astype(np.float32)
    for k in ("weight", "bias", "running_mean", "running_var"):
        v = rng.standard_normal(512).astype(np.float32) * 0.2
        if k == "weight":
            v = v + 1
        if k == "running_var":
            v = np.abs(v) + 0.5
        sd[f"last_bn.{k}"] = v
    return sd


def random_params(seed: int = 0, device="cuda") -> Dict:
    return convert_torch_state_dict(random_torch_style_state_dict(seed),
                                    device=device)
