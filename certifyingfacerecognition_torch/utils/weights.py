"""Parameter-tree persistence, torch-checkpoint ingestion and the
carry-across from the JAX package.

A parameter tree is a nested dict/list of tensors with the JAX package's
keys and layouts. On disk it is the JAX package's flat ``.npz`` (keys are
tree paths joined with ``//``), so one file serves both packages;
``params_from_jax`` turns such a flat dict into the port's tree.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict

import numpy as np
import torch

from .device import resolve_device, tree_map

_SEP = "//"


def flatten_params(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict/list tree (tensors or arrays) -> flat {path: array}."""
    flat = {}
    if isinstance(params, (list, tuple)):
        params = {str(i): v for i, v in enumerate(params)}
    for k, v in params.items():
        path = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            flat.update(flatten_params(v, path))
        elif isinstance(v, torch.Tensor):
            flat[path] = v.detach().cpu().numpy()
        else:
            flat[path] = np.asarray(v)
    return flat


def unflatten_params(flat: Dict[str, np.ndarray]) -> Dict:
    """Inverse of flatten_params, leaves stay numpy. Integer-keyed levels
    whose keys form a dense 0..n-1 range are restored as lists."""
    tree: Dict = {}
    for path, v in flat.items():
        keys = path.split(_SEP)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v

    def restore(node):
        if not isinstance(node, dict):
            return np.asarray(node)
        out = {k: restore(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            idx = sorted(out, key=int)
            if [int(i) for i in idx] == list(range(len(idx))):
                return [out[i] for i in idx]
        return out

    return restore(tree)


def to_torch(tree, device, dtype=torch.float32):
    """numpy tree -> tensor tree on ``device``; floating leaves in dtype.
    Every leaf is a C-contiguous copy: a transposed array would otherwise
    keep its strides, and the convolutions round differently on weights of
    another layout, so a tree would compute differently by the route it
    was loaded by."""
    def leaf(a):
        t = torch.from_numpy(np.array(a, order="C"))
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(leaf, tree)


def params_from_jax(flat: Dict[str, np.ndarray], device="cuda",
                    dtype=torch.float32) -> Dict:
    """The port's parameter tree from the flat arrays that the JAX
    package's ``utils/weights.flatten_params`` / ``save_params`` write."""
    return to_torch(unflatten_params(flat), resolve_device(device), dtype)


def save_params(path: str, params) -> None:
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz",
             **flatten_params(params))


def load_params(path: str, device="cuda") -> Dict:
    with np.load(path) as data:
        return params_from_jax({k: data[k] for k in data.files}, device)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a torch checkpoint (.pth/.pt) into numpy on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}


def load_embeddings(path: str, mmap: bool = False) -> np.ndarray:
    """Load a gallery-embedding array: .npz (key 'embs'), a torch .pth, or
    a bare .npy. If the exact path is missing, the sibling file with another
    extension is probed. mmap=True memory-maps bare .npy files."""
    base, ext = osp.splitext(path)
    if not osp.isfile(path):
        for alt in (".npz", ".pth", ".npy"):
            if alt != ext and osp.isfile(base + alt):
                path, ext = base + alt, alt
                break
    if ext == ".npz":
        with np.load(path) as z:
            return np.asarray(z["embs"])
    if ext in (".pth", ".pt"):
        return torch.load(path, map_location="cpu").numpy()
    return np.load(path, mmap_mode="r" if mmap else None)


def _cached_convert(path: str, convert, device, key: str = "") -> Dict:
    """Load ``path`` (.npz native, or .pth/.pt via ``convert``, a function of
    a numpy state dict returning a numpy tree). Torch checkpoints are
    converted once and cached next to the original, under the JAX
    package's cache name (the trees are the same)."""
    if path.endswith(".npz"):
        return load_params(path, device)
    mtime = int(os.path.getmtime(path))
    suffix = f"-{key}" if key else ""
    cache = f"{path}.cfr{suffix}-{mtime}.npz"
    if osp.isfile(cache):
        return load_params(cache, device)
    tree = convert(load_torch_state_dict(path))
    try:
        save_params(cache, tree)
    except OSError:
        pass  # read-only weight dir: convert in memory every run
    return to_torch(tree, resolve_device(device))


def _seed_of(spec: str, seed: int) -> int:
    return int(spec.split(":", 1)[1]) if ":" in spec else seed


def load_generator_params(spec: str, model_name: str = "stylegan_ffhq",
                          resolution: int = 1024, seed: int = 0,
                          device="cuda") -> Dict:
    """spec: path to .npz/.pth weights, or 'random[:<seed>]' for randomly
    initialised weights (benchmarks / smoke tests only). ``model_name``
    pggan_* loads the PGGAN generator, any other name StyleGAN."""
    from ..models import pggan, stylegan

    mod = pggan if model_name.startswith("pggan") else stylegan
    if spec.startswith("random"):
        return mod.random_params(resolution, seed=_seed_of(spec, seed),
                                 device=device)
    return _cached_convert(
        spec, lambda sd: mod.convert_state_dict_np(sd, resolution),
        device, key=f"r{resolution}")


def load_frm_params(spec: str, frs_method: str = "insightface",
                    seed: int = 0, device="cuda") -> Dict:
    """spec: path to .npz/.pth FRM weights, or 'random[:<seed>]'."""
    from ..models import facenet, iresnet

    if frs_method == "insightface":
        if spec.startswith("random"):
            return iresnet.convert_torch_state_dict(
                iresnet.random_torch_style_state_dict(
                    "iresnet50", seed=_seed_of(spec, seed)), device=device)
        return _cached_convert(spec, iresnet.convert_state_dict_np, device,
                               key="iresnet50")
    if spec.startswith("random"):
        return facenet.random_params(_seed_of(spec, seed), device=device)
    return _cached_convert(spec, facenet.convert_state_dict_np, device,
                           key="facenet")
