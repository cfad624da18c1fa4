"""Median kernel ms of a certify batch's synthesis.pggan_high span over the
profiled identity's batches: the trace's kernels that run between the
span's CUDA events (cfr_bench/spans.kernel_ms), PGGAN's 512^2 and 1024^2
blocks and its ToRGB head (models/pggan.apply)."""

from cfr_bench import spans


def read(rec):
    return spans.device_ms(rec, "synthesis.pggan_high")
