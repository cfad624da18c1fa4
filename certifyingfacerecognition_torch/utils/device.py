"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for ``device``; raises when CUDA is asked for and
    absent (the CPU is used only when the caller asks for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def f32_exact_math() -> None:
    """The f32 parity path runs full-precision float32 convolutions and
    matmuls: TF32 off for cuDNN and cuBLAS (the JAX package runs its f32
    path at Precision.HIGHEST)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def tree_map(fn, tree):
    """Apply fn to every leaf of a nested dict/list parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def device_name(device) -> str:
    """The name a result line gives its device: the GPU's name, or cpu."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
