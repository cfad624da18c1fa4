"""Everything a run makes from ``--seed``: the random weights (as
torch-layout state dicts, drawn on the device in one call each, in the
layout that the configuration's family files state), the streams of the
identities' latents (drawn by the generator family), the gallery's filler
rows, the identities' noise generators and the choice of what the check
compares. Each use draws from its own stream, so adding one leaves the
others as they were."""

from __future__ import annotations

import math

import numpy as np
import torch

# streams of one seed
GEN_WEIGHTS, FRM_WEIGHTS, LATENTS, FILLER, CHOICE, WARMUP = range(6)
NOISE = 1_000          # + identity index: each identity's noise
ATTACK = 2_000_000     # + chunk index: each attack's draws


def derive(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of ``seed`` (any non-negative seed,
    also beyond 32 bits)."""
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(2)
    return (int(state[0]) << 31 ^ int(state[1])) & (2 ** 63 - 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, stream))
    return gen


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, stream))


def state_dict(specs, seed: int, stream: int, device) -> dict:
    """Tensors of ``specs`` ((name, shape, std, mean) each) from one
    normal draw on the device; running variances made positive."""
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator(seed, stream, device),
                       device=device)
    out = {}
    for (name, shape, std, mean), part in zip(specs,
                                              torch.split(flat, sizes)):
        t = part.view(shape) * std + mean
        out[name] = t.abs() if name.endswith("running_var") else t
    return out


def generator_weights(gen, resolution: int, seed: int, device) -> dict:
    """The state dict of generator family ``gen`` at ``resolution``."""
    return state_dict(gen.state_dict_specs(resolution), seed, GEN_WEIGHTS,
                      device)


def frm_weights(frm, seed: int, device) -> dict:
    """The state dict of FRM family ``frm``."""
    return state_dict(frm.state_dict_specs(), seed, FRM_WEIGHTS, device)


def to_numpy(sd: dict) -> dict:
    """A state dict as numpy arrays, as the program's converters take a
    checkpoint."""
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}
