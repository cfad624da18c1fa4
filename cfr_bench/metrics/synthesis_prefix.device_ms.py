"""Median kernel ms of a certify batch's synthesis.prefix span over the
profiled identity's batches: the trace's kernels that run between the
span's CUDA events (cfr_bench/spans.kernel_ms), StyleGAN's plain blocks
up to 256^2."""

from cfr_bench import spans


def read(rec):
    return spans.device_ms(rec, "synthesis.prefix")
