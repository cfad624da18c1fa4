"""Peaks of one H100 SXM (NVIDIA's data sheet, dense rates) and the work
of the synthesis tail counted from its layer shapes, whatever implements
it: each layer reads its input, weights and noise once and writes its
output once, in bf16, and does its multiply-adds (2 FLOPs each)."""

from __future__ import annotations

import math
from typing import Tuple

PEAK_BYTES = 3.35e12          # HBM3 bytes/s
PEAK_BF16 = 989e12            # bf16 tensor-core FLOP/s
BF16 = 2
TAIL_FIRST_RES = 512          # the chain tail's layers, as CFR_TAIL=bc runs


def tail_layers(resolution: int):
    """(kind, input size h, Ci, Co) of the layers at TAIL_FIRST_RES and
    above: the up layer (4x4 stride-2 transposed conv, 2x2 taps per output,
    and the 3x3 depthwise blur), the 3x3 conv, and at ``resolution`` the
    conv with its 1x1 ToRGB."""
    def ch(r):
        return min(512, 16384 // r)

    layers = []
    r = TAIL_FIRST_RES
    while r <= resolution:
        layers.append(("up", r // 2, ch(r // 2), ch(r)))
        layers.append(("conv_rgb" if r == resolution else "conv", r, ch(r),
                       ch(r)))
        r *= 2
    return layers


def layer_work(kind: str, h: int, ci: int, co: int, b: int
               ) -> Tuple[float, float]:
    """(bytes, FLOPs) of one layer at batch ``b``."""
    out_h = 2 * h if kind == "up" else h
    taps = 4 if kind == "up" else 9
    weights = (16 if kind == "up" else 9) * ci * co
    out_c = 3 if kind == "conv_rgb" else co
    nbytes = BF16 * (h * h * ci * b + weights + out_h * out_h * co
                     + out_h * out_h * out_c * b)
    flops = 2.0 * out_h * out_h * b * taps * ci * co
    if kind == "up":
        flops += 2.0 * out_h * out_h * b * co * 9           # the blur
    if kind == "conv_rgb":
        flops += 2.0 * out_h * out_h * b * co * 3
    return nbytes, flops


def tail_bound_ms(resolution: int, b: int) -> Tuple[float, str]:
    """The least time of the tail's layers on one H100, and which term
    bounds it ('bytes' or 'flops')."""
    nbytes = flops = 0.0
    for layer in tail_layers(resolution):
        nb, fl = layer_work(*layer, b)
        nbytes += nb
        flops += fl
    t_bytes, t_flops = nbytes / PEAK_BYTES, flops / PEAK_BF16
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                         else "flops")


def share(work_per_s: float, peak: float) -> float:
    """A rate as a percentage of a peak."""
    if not math.isfinite(work_per_s) or work_per_s <= 0:
        raise ValueError("a share of a peak needs a positive rate")
    return 100.0 * work_per_s / peak
