"""Median kernel ms of a certify batch's gallery_head span over the
profiled identity's batches: the trace's kernels that run between the
span's CUDA events (cfr_bench/spans.kernel_ms), the nearest-identity
search over the gallery."""

from cfr_bench import spans


def read(rec):
    return spans.device_ms(rec, "gallery_head")
