"""Bilinear resize with torch ``F.interpolate(mode='bilinear',
align_corners=False)`` semantics (no antialiasing), as two matmuls with
1-D interpolation matrices (port of certifyingfacerecognition_tpu/ops/
resize.py, which built the same matrices for the TPU's matrix unit)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=16)
def _interp_matrix(out_size: int, in_size: int) -> np.ndarray:
    """[out_size, in_size] row-stochastic bilinear sampling matrix with
    align_corners=False; the source index is computed in float32, as
    torch computes it."""
    M = np.zeros((out_size, in_size), np.float32)
    scale = np.float32(in_size / out_size)
    for o in range(out_size):
        src = (np.float32(o) + np.float32(0.5)) * scale - np.float32(0.5)
        src = float(max(src, np.float32(0.0)))
        i0 = min(int(np.floor(src)), in_size - 1)
        i1 = min(i0 + 1, in_size - 1)
        frac = src - i0
        M[o, i0] += 1.0 - frac
        M[o, i1] += frac
    return M


def _mat(out_size: int, in_size: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(_interp_matrix(out_size, in_size), dtype=like.dtype,
                           device=like.device)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """x: [B, C, H, W] -> [B, C, out_h, out_w]."""
    mv = _mat(out_h, x.shape[2], x)
    mh = _mat(out_w, x.shape[3], x)
    return torch.matmul(torch.matmul(mv, x), mh.t())


def transform_for_frs(images01: torch.Tensor, img_size: int,
                      mean: float = 0.5, std: float = 0.5) -> torch.Tensor:
    """Resize [B, 3, H, W] images in [0, 1] to the FRS input resolution and
    normalise ((x - mean) / std)."""
    x = resize_bilinear(images01, img_size, img_size)
    return (x - mean) / std


def transform_for_frs_cb(images01_cb: torch.Tensor, img_size: int,
                         mean: float = 0.5, std: float = 0.5
                         ) -> torch.Tensor:
    """transform_for_frs for the chain tail's [3, H, W, B] image layout.
    Returns [B, 3, s, s]."""
    _, h, w, _ = images01_cb.shape
    mv = _mat(img_size, h, images01_cb)
    mh = _mat(img_size, w, images01_cb)
    y = torch.einsum("pw,chwb->chpb", mh, images01_cb)
    y = torch.einsum("oh,chpb->copb", mv, y)
    return (y.permute(3, 0, 1, 2) - mean) / std
