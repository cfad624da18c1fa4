"""The program under test, built from the benchmark's inputs: the
configuration's weights made from the seed as torch-layout state dicts,
handed to the port through its generator and FRM family files
(``families.py``; the reference keeps the state dicts), and the attribute
directions from the benchmark's copy of the generator's boundaries."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import families, inputs
from .reference import pipeline as ref

BOUNDARIES = Path(__file__).resolve().parent / "data" / "boundaries"
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def build(ctx) -> SimpleNamespace:
    """The program of the configuration: ``gen`` and ``frm`` its family
    files, ``gen_params``, ``frm_params`` and ``region`` the program's, the
    state dicts and ``dirs_ref`` the reference's. A configuration that
    names a family with no file, or states other widths, is refused here,
    before any weights are drawn."""
    cfg, dev, seed = ctx.config, ctx.device, ctx.seed
    gen, frm = families.of(cfg)
    ref.check_widths(cfg, gen, frm)
    res = cfg["resolution"]
    gen_sd = inputs.generator_weights(gen, res, seed, dev)
    frm_sd = inputs.frm_weights(frm, seed, dev)
    gen_params = gen.to_program(inputs.to_numpy(gen_sd), res, dev)
    frm_params = frm.to_program(inputs.to_numpy(frm_sd), dev)
    return SimpleNamespace(
        res=res, frs=cfg["frs"], dtype=DTYPES[cfg["dtype"]], device=dev,
        gen=gen, frm=frm, gen_sd=gen_sd, frm_sd=frm_sd,
        gen_params=gen_params, frm_params=frm_params,
        region=gen.region(dev, BOUNDARIES),
        dirs_ref=torch.as_tensor(ref.directions(BOUNDARIES, gen.BOUNDARIES),
                                 dtype=torch.float64, device=dev))


def reference_embed(p, w: torch.Tensor, prec, rows: int) -> torch.Tensor:
    """Reference embeddings of latents ``w`` (any float dtype)."""
    with torch.no_grad():
        return ref.embed(p.gen, p.gen_sd, p.frm, p.frm_sd, w.float(), p.res,
                         prec, rows=rows)


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
