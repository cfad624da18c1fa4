"""Median kernel ms of a certify batch's synthesis.tail span over the
profiled identity's batches: the trace's kernels that run between the
span's CUDA events (cfr_bench/spans.kernel_ms), the synthesis from the
chain boundary (the chain kernels from 512^2)."""

from cfr_bench import spans


def read(rec):
    return spans.device_ms(rec, "synthesis.tail")
