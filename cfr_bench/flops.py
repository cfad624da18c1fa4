"""Model FLOPs per sample, counted once by FlopCounterMode over the
benchmark's own reference on meta tensors (shapes only, nothing runs):
the synthesis, the resize, the face-recognition network and the gallery
distances. Only what the reference computes is counted, whatever
implements it in the program."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import facenet, iresnet, pipeline, stylegan


def _meta(specs) -> dict:
    return {name: torch.empty(shape, device="meta")
            for name, shape, _, _ in specs}


def forward_flops(frs: str, resolution: int, gallery_rows: int) -> float:
    """FLOPs of one sample's forward: latent to its distances to
    ``gallery_rows`` gallery rows."""
    gen = _meta(stylegan.state_dict_specs(resolution))
    frm = _meta(iresnet.state_dict_specs() if frs == "insightface"
                else facenet.state_dict_specs())
    w = torch.empty((1, 512), device="meta")
    g = torch.empty((gallery_rows, 512), device="meta")
    with FlopCounterMode(display=False) as counter:
        e = pipeline.embed(gen, frm, frs, w, resolution)
        pipeline.distances(frs, e, g)
    return float(counter.get_total_flops())
