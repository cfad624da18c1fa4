"""Share of the profiled attack's kernel time, in %, in kernels that are
neither matrix products or convolutions (cuBLAS, cuDNN, CUTLASS) nor the
synthesis tail's hand-written kernels: PyTorch's elementwise and
reduction kernels."""

HEAVY = ("gemm", "xmma", "cutlass", "cudnn", "convolve", "implicit",
         "fprop", "dgrad", "wgrad", "conv3x3_kernel", "up_kernel",
         "up_wgmma_kernel")


def read(rec):
    if rec.get("kind") != "attack":
        return None
    total = sum(d for _, _, d in rec["kernels"])
    if total <= 0:
        return None
    light = sum(d for n, _, d in rec["kernels"]
                if not any(h in n.lower() for h in HEAVY))
    return 100.0 * light / total
