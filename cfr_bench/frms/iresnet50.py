"""ArcFace iresnet-50 (insightface ``arcface_torch/backbones/iresnet.py``):
the FRM family of a configuration whose ``frm_arch`` is ``iresnet50``, on
a 112^2 input with a Euclidean gallery head. The reference is
``reference/iresnet.py``; the program's converter is the port's
``models/iresnet.convert_torch_state_dict``. See ``cfr_bench/families.py``.
"""

from __future__ import annotations

from cfr_bench.reference import iresnet

ARCH = "iresnet50"
FRS = ("insightface",)
INPUT = 112
EMBEDDING_DIM = 512


def widths() -> dict:
    return {"frm_input": INPUT, "embedding_dim": EMBEDDING_DIM}


def state_dict_specs():
    return iresnet.state_dict_specs(ARCH)


def embed(sd, x, prec):
    return iresnet.embed(sd, x, ARCH, prec=prec)


def to_program(sd: dict, device):
    from certifyingfacerecognition_torch.models import iresnet as P

    return P.convert_torch_state_dict(sd, ARCH, device=device)
