"""PyTorch/CUDA port of certifyingfacerecognition_tpu.

Same functions, flags and file formats as the JAX package, run with
PyTorch on an NVIDIA GPU; the StyleGAN synthesis tail's kernels are
hand-written for Hopper (csrc/). Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""
