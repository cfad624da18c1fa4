"""The program under test, built from the benchmark's inputs: the
configuration's weights made from the seed as torch-layout state dicts,
handed to the port through its public converters (the reference keeps the
state dicts), and the attribute directions from the benchmark's copy of
InterFaceGAN's boundaries."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import inputs
from .reference import pipeline as ref

BOUNDARIES = str(Path(__file__).resolve().parent / "data" / "boundaries")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def build(ctx) -> SimpleNamespace:
    from certifyingfacerecognition_torch.models import (facenet, iresnet,
                                                        stylegan)
    from certifyingfacerecognition_torch.ops import geometry as G

    cfg, dev, seed = ctx.config, ctx.device, ctx.seed
    ref.check_widths(cfg)
    res, frs = cfg["resolution"], cfg["frs"]
    gen_sd = inputs.generator_weights(res, seed, dev)
    frm_sd = inputs.frm_weights(frs, seed, dev)
    gen_params = stylegan.convert_torch_state_dict(
        inputs.to_numpy(gen_sd), res, device=dev)
    if frs == "insightface":
        frm_params = iresnet.convert_torch_state_dict(
            inputs.to_numpy(frm_sd), cfg["frm_arch"], device=dev)
    else:
        frm_params = facenet.convert_torch_state_dict(
            inputs.to_numpy(frm_sd), device=dev)
    region = G.get_all_matrices(boundaries_dir=BOUNDARIES, device=dev)
    return SimpleNamespace(
        res=res, frs=frs, dtype=DTYPES[cfg["dtype"]], gen_sd=gen_sd,
        frm_sd=frm_sd, gen_params=gen_params, frm_params=frm_params,
        region=region, dirs_ref=torch.as_tensor(
            ref.directions(BOUNDARIES), dtype=torch.float64, device=dev))


def reference_embed(p, w: torch.Tensor, prec, rows: int) -> torch.Tensor:
    """Reference embeddings of latents ``w`` (any float dtype)."""
    with torch.no_grad():
        return ref.embed(p.gen_sd, p.frm_sd, p.frs, w.float(), p.res, prec,
                         rows=rows)


def filler_rows(id_rows: torch.Tensor, xi: torch.Tensor, frs: str
                ) -> torch.Tensor:
    """Gallery rows of further identities, distributed as the identities'
    own rows are: their per-dimension mean and spread over standard normal
    draws ``xi``, unit vectors for FaceNet. The program's gallery is made
    from its rows, the reference's from its own, with the same draws."""
    rows = id_rows.double()
    out = rows.mean(0) + rows.std(0) * xi.double()
    if frs != "insightface":
        out = out / out.norm(dim=1, keepdim=True)
    return out.float()


def rel_err(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a_i - b_i|| / ||b_i|| per row, in float64."""
    a, b = a.double(), b.double()
    return (a - b).norm(dim=1) / b.norm(dim=1).clamp(min=1e-30)


def to_host(x) -> np.ndarray:
    return x.detach().cpu().numpy()
