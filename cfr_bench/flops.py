"""Model FLOPs per sample, counted once by FlopCounterMode over the
benchmark's own reference on meta tensors (shapes only, nothing runs):
the synthesis, the resize, the face-recognition network and the gallery
distances. Only what the reference computes is counted, whatever
implements it in the program."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import families
from .reference import pipeline


def _meta(specs) -> dict:
    return {name: torch.empty(shape, device="meta")
            for name, shape, _, _ in specs}


def forward_flops(config: dict, gallery_rows: int) -> float:
    """FLOPs of one sample's forward in configuration ``config`` (its
    family files, resolution and gallery head): latent to its distances
    to ``gallery_rows`` gallery rows."""
    gen, frm = families.of(config)
    res = config["resolution"]
    gen_sd = _meta(gen.state_dict_specs(res))
    frm_sd = _meta(frm.state_dict_specs())
    w = torch.empty((1, gen.LATENT_DIM), device="meta")
    g = torch.empty((gallery_rows, frm.EMBEDDING_DIM), device="meta")
    with FlopCounterMode(display=False) as counter:
        e = pipeline.embed(gen, gen_sd, frm, frm_sd, w, res)
        pipeline.distances(config["frs"], e, g)
    return float(counter.get_total_flops())
