"""Device selection for the port's entry points."""

from __future__ import annotations

import subprocess

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


def device_label(device) -> str:
    """The name a benchmark line gives its device: the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them, or cpu. nvidia-smi is asked by the
    card's UUID: its indices follow the PCI order, not torch's, which
    CUDA_VISIBLE_DEVICES renumbers."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    uuid = str(torch.cuda.get_device_properties(index).uuid)
    if not uuid.startswith(("GPU-", "MIG-")):
        uuid = "GPU-" + uuid
    return subprocess.run(
        ["nvidia-smi", f"--id={uuid}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
