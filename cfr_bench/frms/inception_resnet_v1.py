"""FaceNet InceptionResnetV1 (timesler/facenet-pytorch): the FRM family of
a configuration whose ``frm_arch`` is ``inception_resnet_v1``, on a 160^2
input with a cosine gallery head (unit embeddings). The reference is
``reference/facenet.py``; the program's converter is the port's
``models/facenet.convert_torch_state_dict``. See
``cfr_bench/families.py``.
"""

from __future__ import annotations

from cfr_bench.reference import facenet

FRS = ("facenet", "facenet-vggface2")
INPUT = 160
EMBEDDING_DIM = 512


def widths() -> dict:
    return {"frm_input": INPUT, "embedding_dim": EMBEDDING_DIM}


def state_dict_specs():
    return facenet.state_dict_specs()


def embed(sd, x, prec):
    return facenet.embed(sd, x, prec=prec)


def to_program(sd: dict, device):
    from certifyingfacerecognition_torch.models import facenet as P

    return P.convert_torch_state_dict(sd, device=device)
