"""The benchmark's plain reference: StyleGAN synthesis, ArcFace iresnet-50,
FaceNet InceptionResnetV1, the bilinear resize, the gallery distances, the
Clopper-Pearson certificate and the attribute ellipsoid, in plain PyTorch
and NumPy, computed from the torch-layout state dicts the benchmark makes.

It imports nothing of the program under test: the tests hold that by AST.
Every forward takes a ``Precision``: ``F32`` is the reference itself (TF32
off), ``FP8`` the correctness control (each convolution's and matrix
product's operands rounded to float8 e4m3 with a per-tensor scale, the
step below the bf16 that the configurations state).
"""
