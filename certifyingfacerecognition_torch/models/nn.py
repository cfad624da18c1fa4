"""Shared NN primitives (NCHW activations; HWIO kernels as stored in the
parameter trees, shared with the JAX package).

The port keeps the JAX package's parameter layouts (HWIO conv kernels,
[in, out] dense weights) so that a parameter tree carries across
unchanged (utils/weights.params_from_jax); the convolutions reorder a
kernel to torch's OIHW as they use it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A [C] vector shaped to broadcast over dim 1 of x."""
    return v.reshape((1, -1) + (1,) * (x.dim() - 2))


def conv2d(x: torch.Tensor, k_hwio: torch.Tensor, padding=1,
           stride: int = 1, groups: int = 1) -> torch.Tensor:
    """NCHW conv with an HWIO kernel (zero padding). ``padding`` is an int
    (every side) or ((top, bottom), (left, right)), as the JAX package's
    conv2d takes it."""
    if not isinstance(padding, int):
        (top, bottom), (left, right) = padding
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = 0
    return F.conv2d(x, k_hwio.permute(3, 2, 0, 1), padding=padding,
                    stride=stride, groups=groups)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 VALID max-pool of NCHW x."""
    return F.max_pool2d(x, 3, stride=2)


def upconv(x: torch.Tensor, k4_hwio: torch.Tensor) -> torch.Tensor:
    """The fused-scale 4x4 stride-2 transposed conv of StyleGAN. k4_hwio is
    the forward-conv (spatially flipped) form the JAX package stores; torch's
    conv_transpose2d takes the unflipped [in, out, 4, 4] kernel."""
    wt = torch.flip(k4_hwio, (0, 1)).permute(2, 3, 0, 1)
    return F.conv_transpose2d(x, wt, stride=2, padding=1)


def lrelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Per-channel PReLU over dim 1."""
    return torch.where(x >= 0, x, _per_channel(alpha, x) * x)


def affine_channels(x: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor) -> torch.Tensor:
    """Per-channel affine over dim 1 (folded BatchNorm)."""
    return x * _per_channel(scale, x) + _per_channel(shift, x)


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Normalise over the channel axis (dim 1)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + eps)


def instance_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-sample, per-channel spatial normalisation of NCHW x. f32: the
    exact two-pass formula. bf16: one-pass f32 moments (E[x^2]-E[x]^2,
    clamped at 0) and a bf16 apply, as the JAX package's bf16 path."""
    if x.dtype == torch.float32:
        mean = x.mean((2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean((2, 3), keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps)
    xf = x.float()
    m = xf.mean((2, 3), keepdim=True)
    m2 = (xf * xf).mean((2, 3), keepdim=True)
    var = torch.clamp(m2 - m * m, min=0.0)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return (x - m.to(x.dtype)) * scale


def nearest_up_conv3_as_tconv_kernel(k3: torch.Tensor) -> torch.Tensor:
    """Rewrite ``upsample_nearest_2x -> conv3x3(pad 1)`` as one 4x4 stride-2
    transposed conv: returns the HWIO kernel T for ``upconv`` with
    T = M K M^T per (i, o) slice, M = [[1,0,0],[1,1,0],[0,1,1],[0,0,1]]."""
    m = torch.tensor([[1, 0, 0], [1, 1, 0], [0, 1, 1], [0, 0, 1]],
                     dtype=k3.dtype, device=k3.device)
    return torch.einsum("ap,bq,pqio->abio", m, m, k3)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def blur_3x3(x: torch.Tensor) -> torch.Tensor:
    """Depthwise binomial [1,2,1] x [1,2,1] / 16 blur, zero padding."""
    c = x.shape[1]
    k1 = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype, device=x.device)
    k = torch.outer(k1, k1) / 16.0
    return F.conv2d(x, k.expand(c, 1, 3, 3), padding=1, groups=c)


def fold_batchnorm(gamma, beta, mean, var, eps):
    """Fold BN running stats into an affine (scale, shift) pair."""
    gamma = np.asarray(gamma, np.float64)
    beta = np.asarray(beta, np.float64)
    mean = np.asarray(mean, np.float64)
    var = np.asarray(var, np.float64)
    scale = gamma / np.sqrt(var + eps)
    shift = beta - mean * scale
    return scale.astype(np.float32), shift.astype(np.float32)


def torch_conv_to_hwio(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def torch_linear_to_io(w: np.ndarray) -> np.ndarray:
    """[out, in] -> [in, out]."""
    return np.transpose(np.asarray(w), (1, 0))
