"""Operand precision of the reference's convolutions and matrix products."""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


class Precision:
    """``q(t)`` rounds a tensor: the identity in float32, to bfloat16, or
    to float8 e4m3 with a per-tensor scale (amax maps to the format's
    largest value). Below float32 every convolution and matrix product
    takes rounded operands and its result is rounded as it is stored, and
    the forwards round each activation they store, as the program in bf16
    stores its own; sums inside an operation stay float32."""

    def __init__(self, name: str):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {name}")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "f32" or t.device.type == "meta":
            return t
        if self.name == "bf16":
            qt = t.detach().to(torch.bfloat16).float()
        else:
            scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
            qt = (t.detach() / scale).to(torch.float8_e4m3fn).float() \
                * scale
        # gradients pass straight through, in float32
        return t + (qt - t).detach() if t.requires_grad else qt

    def conv2d(self, x, w, bias=None, stride=1, padding=0, groups=1):
        return self.q(F.conv2d(self.q(x), self.q(w), bias, stride=stride,
                               padding=padding, groups=groups))

    def conv_transpose2d(self, x, w, stride=2, padding=1):
        return self.q(F.conv_transpose2d(self.q(x), self.q(w), stride=stride,
                                         padding=padding))

    def linear(self, x, w, bias=None):
        """x @ w.T (+ bias), w in torch's [out, in] layout."""
        return self.q(F.linear(self.q(x), self.q(w), bias))


F32 = Precision("f32")
BF16 = Precision("bf16")
FP8 = Precision("fp8")


def exact_f32() -> None:
    """Full float32 products on the card: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
