"""ProgressiveGAN CelebA-HQ 1024^2 (Karras et al., ICLR 2018; InterFaceGAN's
``pggan_generator``): the generator family of a configuration whose
``generator`` is ``progan_celebahq``; the port names this generator
``pggan_celebahq`` (``PROGRAM_NAME``). See ``cfr_bench/families.py`` for
what a generator file provides.

Reference half: the widths, state-dict layout and synthesis of
``reference/pggan.py`` (the Z normalisation, then the 18 pixel-normed
convolutions and the ToRGB head); identities are latents in Z; the
directions are InterFaceGAN's Z-space boundaries. Program half: the
port's PGGAN converter, its Z region matrices, its ``FacePipeline`` and
``make_dists_fn`` with ``generator="pggan_celebahq"``. Both halves take
the weights through ``steered``: the first convolution's weights as
drawn, plus the configuration's assumed mean along the five boundaries
(``EDIT_GAIN``). No staged timing (``stages`` is None): the program's own
spans ``synthesis.pggan_low`` and ``synthesis.pggan_high`` split the
synthesis, and ``high_work`` gives the work of the second for its
roofline.
"""

from __future__ import annotations

import math
from functools import lru_cache
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from cfr_bench import harness, inputs, roofline
from cfr_bench.reference import pggan
from cfr_bench.reference.pipeline import ATTRS, directions

PROGRAM_NAME = "pggan_celebahq"
LATENT_DIM = pggan.LATENT_DIM
BOUNDARIES = tuple(f"pggan_celebahq_{a}_boundary.npy" for a, _ in ATTRS)
HIGH_MIN_RES = 512            # synthesis.pggan_high's first resolution
# The configuration's ``assumed`` generator_steering: the first convolution
# (Z onto the 4x4 features) has, besides its N(0, 1) draw, the mean
# EDIT_GAIN * 512 / sqrt(5) * B^T B at each of its 16 taps (B: the five
# unit boundaries, [5, 512]). A latent's coordinates along the boundaries
# then drive that layer EDIT_GAIN times as strongly as its other 507
# coordinates together, as the attributes by which InterFaceGAN found
# these boundaries steer a trained generator; with none, a sigma-0.1 edit
# moves a 1024^2 embedding by less than bf16 rounds it, and no check tells
# an edit from none (PERF.md, section 2).
EDIT_GAIN = 2.0
STEERED = "layer0.conv.weight"


@lru_cache(maxsize=1)
def layer0_mean() -> np.ndarray:
    """The assumed mean of the first convolution's weights, [512, 512]
    (the same at each tap), in float32; computed in NumPy, so that no
    FLOP counter sees it."""
    b = directions(harness.HERE / "data" / "boundaries", BOUNDARIES)
    return (EDIT_GAIN * LATENT_DIM / math.sqrt(len(b))
            * (b.T @ b)).astype(np.float32)


def steered(sd: dict) -> dict:
    """The state dict ``sd`` (torch tensors or NumPy arrays) with the
    assumed mean added to the first convolution's weights."""
    w = sd[STEERED]
    if isinstance(w, np.ndarray):
        mean = layer0_mean()
    else:
        mean = torch.as_tensor(layer0_mean(), dtype=w.dtype, device=w.device)
    return dict(sd, **{STEERED: w + mean[:, :, None, None]})


def widths(resolution: int) -> dict:
    return {"synthesis_layers": pggan.num_layers(resolution),
            "z_dim": LATENT_DIM,
            "channels_max": pggan.channels_at(4),
            "channels_min": pggan.channels_at(resolution),
            "torgb_resolution": resolution,
            "z_sphere_radius": math.sqrt(LATENT_DIM)}


def state_dict_specs(resolution: int):
    return pggan.state_dict_specs(resolution)


def synthesize(sd, z: torch.Tensor, resolution: int, prec) -> torch.Tensor:
    return pggan.synthesize(steered(sd), z, resolution, prec)


def latents(n: int, seed: int, device) -> torch.Tensor:
    """Identities drawn in Z: [n, 512] standard normal rows (the
    generator puts each on the sqrt(512) sphere)."""
    return torch.randn((n, LATENT_DIM),
                       generator=inputs.generator(seed, inputs.LATENTS,
                                                  device), device=device)


def high_layers(resolution: int):
    """(kind, input size h, Ci, Co) of the convolutions from HIGH_MIN_RES
    up, as the program runs them: each resolution's up layer (nearest 2x
    and the 3x3 conv as one stride-2 transposed conv, 2x2 taps an output)
    and its 3x3 conv, then the 1x1 ToRGB."""
    layers = []
    r = HIGH_MIN_RES
    while r <= resolution:
        layers.append(("up", r // 2, pggan.channels_at(r // 2),
                       pggan.channels_at(r)))
        layers.append(("conv", r, pggan.channels_at(r),
                       pggan.channels_at(r)))
        r *= 2
    if resolution >= HIGH_MIN_RES:
        layers.append(("rgb", resolution, pggan.channels_at(resolution), 3))
    return layers


def high_work(resolution: int, batch: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of synthesis.pggan_high's layers at ``batch``, by
    roofline.py's rule: each layer reads its input and weights once and
    writes its output once, in bf16 (the pixel norm, bias and leaky ReLU
    ride on those passes), and does its multiply-adds (2 FLOPs each)."""
    taps = {"up": 4, "conv": 9, "rgb": 1}
    nbytes = flops = 0.0
    for kind, h, ci, co in high_layers(resolution):
        out_h = 2 * h if kind == "up" else h
        k = 16 if kind == "up" else taps[kind]
        nbytes += roofline.BF16 * (h * h * ci * batch + k * ci * co + co
                                   + out_h * out_h * co * batch)
        flops += 2.0 * out_h * out_h * batch * taps[kind] * ci * co
    return nbytes, flops


def high_bound_ms(resolution: int, batch: int) -> float:
    """The least time of high_work on one H100 (roofline.py's peaks)."""
    nbytes, flops = high_work(resolution, batch)
    return 1e3 * max(nbytes / roofline.PEAK_BYTES, flops / roofline.PEAK_BF16)


def to_program(sd: dict, resolution: int, device):
    from certifyingfacerecognition_torch.models import pggan as P

    return P.convert_torch_state_dict(steered(sd), resolution, device=device)


def region(device, boundaries_dir: Path):
    from certifyingfacerecognition_torch.ops import geometry as G

    return G.get_all_matrices(boundaries_dir=str(boundaries_dir),
                              device=device, model_name=PROGRAM_NAME)


def pipeline(p, gallery=None):
    from certifyingfacerecognition_torch.models.pipeline import FacePipeline

    return FacePipeline(p.gen_params, p.frm_params, dirs=p.region.dirs.t(),
                        frs_method=p.frs, resolution=p.res, dtype=p.dtype,
                        gallery=gallery, device=p.device,
                        generator=PROGRAM_NAME)


def dists_fn(p, remat: bool = True):
    from certifyingfacerecognition_torch.eval.chunk_runner import \
        make_dists_fn

    return make_dists_fn(p.frs, p.res, p.dtype, remat=remat,
                         generator=PROGRAM_NAME)


def stages(p, w: torch.Tensor):
    return None
