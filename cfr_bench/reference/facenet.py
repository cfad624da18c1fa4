"""FaceNet InceptionResnetV1 (facenet-pytorch ``models/
inception_resnet_v1.py``), eval mode, in plain PyTorch over that file's
state-dict names: the conv2d_1a..conv2d_4b stem, 5 Block35 (scale 0.17),
Mixed_6a, 10 Block17 (0.10), Mixed_7a, 5 Block8 (0.20), the last Block8
without ReLU, average pooling, last_linear, last_bn and the L2
normalisation. BasicConv2d is conv (no bias) -> BN (eps 1e-3) -> ReLU.
160^2 input, 512-d unit-norm output.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import F32, Precision

BN_EPS = 1e-3


def _basic(sd, pre, x, prec, stride=1, padding=0):
    x = prec.conv2d(x, sd[f"{pre}.conv.weight"], stride=stride,
                    padding=padding)
    inv = torch.rsqrt(sd[f"{pre}.bn.running_var"] + BN_EPS) * \
        sd[f"{pre}.bn.weight"]
    x = (x - sd[f"{pre}.bn.running_mean"][:, None, None]) * \
        inv[:, None, None] + sd[f"{pre}.bn.bias"][:, None, None]
    return prec.q(F.relu(x))


def _up(sd, pre, branches, prec):
    return prec.conv2d(torch.cat(branches, 1), sd[f"{pre}.conv2d.weight"],
                       sd[f"{pre}.conv2d.bias"])


def _block35(sd, pre, x, prec):
    b0 = _basic(sd, f"{pre}.branch0", x, prec)
    b1 = _basic(sd, f"{pre}.branch1.0", x, prec)
    b1 = _basic(sd, f"{pre}.branch1.1", b1, prec, padding=1)
    b2 = _basic(sd, f"{pre}.branch2.0", x, prec)
    b2 = _basic(sd, f"{pre}.branch2.1", b2, prec, padding=1)
    b2 = _basic(sd, f"{pre}.branch2.2", b2, prec, padding=1)
    return prec.q(F.relu(_up(sd, pre, [b0, b1, b2], prec) * 0.17 + x))


def _block17(sd, pre, x, prec):
    b0 = _basic(sd, f"{pre}.branch0", x, prec)
    b1 = _basic(sd, f"{pre}.branch1.0", x, prec)
    b1 = _basic(sd, f"{pre}.branch1.1", b1, prec, padding=(0, 3))
    b1 = _basic(sd, f"{pre}.branch1.2", b1, prec, padding=(3, 0))
    return prec.q(F.relu(_up(sd, pre, [b0, b1], prec) * 0.10 + x))


def _block8(sd, pre, x, prec, scale, relu):
    b0 = _basic(sd, f"{pre}.branch0", x, prec)
    b1 = _basic(sd, f"{pre}.branch1.0", x, prec)
    b1 = _basic(sd, f"{pre}.branch1.1", b1, prec, padding=(0, 1))
    b1 = _basic(sd, f"{pre}.branch1.2", b1, prec, padding=(1, 0))
    out = _up(sd, pre, [b0, b1], prec) * scale + x
    return prec.q(F.relu(out) if relu else out)


def embed(sd, x: torch.Tensor, prec: Precision = F32) -> torch.Tensor:
    """[B, 3, 160, 160] normalised images -> [B, 512] unit embeddings."""
    x = _basic(sd, "conv2d_1a", x, prec, stride=2)
    x = _basic(sd, "conv2d_2a", x, prec)
    x = _basic(sd, "conv2d_2b", x, prec, padding=1)
    x = F.max_pool2d(x, 3, stride=2)
    x = _basic(sd, "conv2d_3b", x, prec)
    x = _basic(sd, "conv2d_4a", x, prec)
    x = _basic(sd, "conv2d_4b", x, prec, stride=2)
    for i in range(5):
        x = _block35(sd, f"repeat_1.{i}", x, prec)
    x = torch.cat([
        _basic(sd, "mixed_6a.branch0", x, prec, stride=2),
        _basic(sd, "mixed_6a.branch1.2", _basic(
            sd, "mixed_6a.branch1.1", _basic(sd, "mixed_6a.branch1.0", x,
                                             prec), prec, padding=1),
            prec, stride=2),
        F.max_pool2d(x, 3, stride=2)], 1)
    for i in range(10):
        x = _block17(sd, f"repeat_2.{i}", x, prec)
    b0 = _basic(sd, "mixed_7a.branch0.1", _basic(
        sd, "mixed_7a.branch0.0", x, prec), prec, stride=2)
    b1 = _basic(sd, "mixed_7a.branch1.1", _basic(
        sd, "mixed_7a.branch1.0", x, prec), prec, stride=2)
    b2 = _basic(sd, "mixed_7a.branch2.0", x, prec)
    b2 = _basic(sd, "mixed_7a.branch2.1", b2, prec, padding=1)
    b2 = _basic(sd, "mixed_7a.branch2.2", b2, prec, stride=2)
    x = torch.cat([b0, b1, b2, F.max_pool2d(x, 3, stride=2)], 1)
    for i in range(5):
        x = _block8(sd, f"repeat_3.{i}", x, prec, 0.20, True)
    x = _block8(sd, "block8", x, prec, 1.0, False)
    x = prec.linear(prec.q(x.mean((2, 3))), sd["last_linear.weight"])
    inv = torch.rsqrt(sd["last_bn.running_var"] + BN_EPS) * \
        sd["last_bn.weight"]
    x = prec.q((x - sd["last_bn.running_mean"]) * inv + sd["last_bn.bias"])
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(
        min=1e-12)


def state_dict_specs():
    """(name, shape, std, mean) of every tensor, in a fixed order:
    convolutions He-scaled, BN statistics near the identity."""
    specs = []

    def conv_bn(pre, ci, co, kh, kw):
        specs.append((f"{pre}.conv.weight", (co, ci, kh, kw),
                      math.sqrt(2.0 / (ci * kh * kw)), 0.0))
        specs.extend([(f"{pre}.bn.weight", (co,), 0.1, 1.0),
                      (f"{pre}.bn.bias", (co,), 0.1, 0.0),
                      (f"{pre}.bn.running_mean", (co,), 0.1, 0.0),
                      (f"{pre}.bn.running_var", (co,), 0.1, 1.0)])

    def plain(pre, ci, co):
        specs.append((f"{pre}.weight", (co, ci, 1, 1),
                      math.sqrt(1.0 / ci), 0.0))
        specs.append((f"{pre}.bias", (co,), 0.1, 0.0))

    conv_bn("conv2d_1a", 3, 32, 3, 3)
    conv_bn("conv2d_2a", 32, 32, 3, 3)
    conv_bn("conv2d_2b", 32, 64, 3, 3)
    conv_bn("conv2d_3b", 64, 80, 1, 1)
    conv_bn("conv2d_4a", 80, 192, 3, 3)
    conv_bn("conv2d_4b", 192, 256, 3, 3)
    for i in range(5):
        p = f"repeat_1.{i}"
        conv_bn(f"{p}.branch0", 256, 32, 1, 1)
        conv_bn(f"{p}.branch1.0", 256, 32, 1, 1)
        conv_bn(f"{p}.branch1.1", 32, 32, 3, 3)
        conv_bn(f"{p}.branch2.0", 256, 32, 1, 1)
        conv_bn(f"{p}.branch2.1", 32, 32, 3, 3)
        conv_bn(f"{p}.branch2.2", 32, 32, 3, 3)
        plain(f"{p}.conv2d", 96, 256)
    conv_bn("mixed_6a.branch0", 256, 384, 3, 3)
    conv_bn("mixed_6a.branch1.0", 256, 192, 1, 1)
    conv_bn("mixed_6a.branch1.1", 192, 192, 3, 3)
    conv_bn("mixed_6a.branch1.2", 192, 256, 3, 3)
    for i in range(10):
        p = f"repeat_2.{i}"
        conv_bn(f"{p}.branch0", 896, 128, 1, 1)
        conv_bn(f"{p}.branch1.0", 896, 128, 1, 1)
        conv_bn(f"{p}.branch1.1", 128, 128, 1, 7)
        conv_bn(f"{p}.branch1.2", 128, 128, 7, 1)
        plain(f"{p}.conv2d", 256, 896)
    conv_bn("mixed_7a.branch0.0", 896, 256, 1, 1)
    conv_bn("mixed_7a.branch0.1", 256, 384, 3, 3)
    conv_bn("mixed_7a.branch1.0", 896, 256, 1, 1)
    conv_bn("mixed_7a.branch1.1", 256, 256, 3, 3)
    conv_bn("mixed_7a.branch2.0", 896, 256, 1, 1)
    conv_bn("mixed_7a.branch2.1", 256, 256, 3, 3)
    conv_bn("mixed_7a.branch2.2", 256, 256, 3, 3)
    for p in [f"repeat_3.{i}" for i in range(5)] + ["block8"]:
        conv_bn(f"{p}.branch0", 1792, 192, 1, 1)
        conv_bn(f"{p}.branch1.0", 1792, 192, 1, 1)
        conv_bn(f"{p}.branch1.1", 192, 192, 1, 3)
        conv_bn(f"{p}.branch1.2", 192, 192, 3, 1)
        plain(f"{p}.conv2d", 384, 1792)
    specs.append(("last_linear.weight", (512, 1792), math.sqrt(1.0 / 1792),
                  0.0))
    specs.extend([("last_bn.weight", (512,), 0.1, 1.0),
                  ("last_bn.bias", (512,), 0.1, 0.0),
                  ("last_bn.running_mean", (512,), 0.1, 0.0),
                  ("last_bn.running_var", (512,), 0.1, 1.0)])
    return specs
