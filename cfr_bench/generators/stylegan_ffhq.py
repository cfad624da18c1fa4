"""StyleGAN FFHQ (Karras et al., CVPR 2019; InterFaceGAN's
``stylegan_generator``): the generator family of a configuration whose
``generator`` is ``stylegan_ffhq``. See ``cfr_bench/families.py`` for what
a generator file provides.

Reference half: the widths, state-dict layout and synthesis of
``reference/stylegan.py`` (truncation, then the synthesis network);
identities are latents in W; the directions are InterFaceGAN's W-space
boundaries. Program half: the port's converter and region matrices, its
``FacePipeline`` and ``make_dists_fn``, and a certify batch timed up to
256^2, through the whole synthesis and through the embedding.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from cfr_bench import inputs
from cfr_bench.reference import stylegan
from cfr_bench.reference.pipeline import ATTRS

LATENT_DIM = stylegan.W_DIM
BOUNDARIES = tuple(f"stylegan_ffhq_{a}_w_boundary.npy" for a, _ in ATTRS)
TAIL_SPLIT_RES = 256          # the staged prefix ends with this block


def widths(resolution: int) -> dict:
    return {"mapping_layers": stylegan.MAPPING_LAYERS,
            "synthesis_layers": stylegan.num_layers(resolution),
            "w_dim": stylegan.W_DIM,
            "channels_max": stylegan.channels_at(4),
            "channels_min": stylegan.channels_at(resolution),
            "truncation_psi": stylegan.TRUNCATION_PSI,
            "truncation_layers": stylegan.TRUNCATION_LAYERS}


def state_dict_specs(resolution: int):
    return stylegan.state_dict_specs(resolution)


def synthesize(sd, w: torch.Tensor, resolution: int, prec) -> torch.Tensor:
    return stylegan.synthesize(sd, w, resolution, prec)


def latents(n: int, seed: int, device) -> torch.Tensor:
    """Identities drawn in W: [n, 512] standard normal rows."""
    return torch.randn((n, LATENT_DIM),
                       generator=inputs.generator(seed, inputs.LATENTS,
                                                  device), device=device)


def to_program(sd: dict, resolution: int, device):
    from certifyingfacerecognition_torch.models import stylegan as P

    return P.convert_torch_state_dict(sd, resolution, device=device)


def region(device, boundaries_dir: Path):
    from certifyingfacerecognition_torch.ops import geometry as G

    return G.get_all_matrices(boundaries_dir=str(boundaries_dir),
                              device=device)


def pipeline(p, gallery=None):
    from certifyingfacerecognition_torch.models.pipeline import FacePipeline

    return FacePipeline(p.gen_params, p.frm_params, dirs=p.region.dirs.t(),
                        frs_method=p.frs, resolution=p.res, dtype=p.dtype,
                        gallery=gallery, device=p.device)


def dists_fn(p, remat: bool = True):
    from certifyingfacerecognition_torch.eval.chunk_runner import \
        make_dists_fn

    return make_dists_fn(p.frs, p.res, p.dtype, remat=remat)


def stages(p, w: torch.Tensor) -> dict:
    from certifyingfacerecognition_torch.models import stylegan as P
    from certifyingfacerecognition_torch.models.pipeline import \
        make_lat2embs

    gen, frm = p.gen_params, p.frm_params
    stop = int(math.log2(min(TAIL_SPLIT_RES, p.res)))
    embed = make_lat2embs(p.frs, p.res, p.dtype)
    return {
        "pre": lambda: P.synthesis_prefix(
            gen, P.truncation_apply(gen, w, resolution=p.res),
            resolution=p.res, dtype=p.dtype, stop=stop),
        "synth": lambda: P.synthesize_from_w(
            gen, w, resolution=p.res, dtype=p.dtype,
            cb_out=P.cb_out_active(p.res, p.dtype)),
        "embed": lambda: embed(gen, frm, w),
    }
