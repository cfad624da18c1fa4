"""Pipeline-wide constants (the values of certifyingfacerecognition_tpu/
constants.py that the port uses)."""

from collections import OrderedDict

# Per-attribute perturbation budgets (semi-axes of the semantic
# hyper-ellipsoid).
ATTRS = OrderedDict(
    [
        ("age", 0.5),
        ("eyeglasses", 0.5),
        ("gender", 0.2),
        ("pose", 0.5),
        ("smile", 0.8),
    ]
)

# Face-recognition systems and their input resolutions.
FRS_METHODS = ["insightface", "facenet", "facenet-vggface2"]
INP_RESOLS = {"insightface": 112, "facenet": 160, "facenet-vggface2": 160}

# Image normalisation applied before the FRS (Normalize(0.5, 0.5)).
MEAN = 0.5
STD = 0.5

# Embedding / latent dimensionality.
EMB_SIZE = 512

# Attack surface: loss types, optimisers and attack names of the attack CLI.
LOSS_TYPES = ["away", "nearest", "diff", "xent", "dlr"]
OPTIMS = ["Adam", "SGD", "RMSProp"]
ATTACKS = ["fab-t", "fab", "apgd-ce", "apgd-dlr", "apgd-t", "manual",
           "square", "autoattack", "autoattack-rand", "autoattack-plus"]

# StyleGAN inference settings.
STYLEGAN_TRUNCATION_PSI = 0.7
STYLEGAN_TRUNCATION_LAYERS = 8
