"""Median kernel ms of a certify batch's frm span over the profiled
identity's batches: the trace's kernels that run between the span's CUDA
events (cfr_bench/spans.kernel_ms), the resize, normalisation and
face-recognition network."""

from cfr_bench import spans


def read(rec):
    return spans.device_ms(rec, "frm")
