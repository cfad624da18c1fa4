"""Median kernel ms of a certify batch's synthesis.pggan_low span over the
profiled identity's batches: the trace's kernels that run between the
span's CUDA events (cfr_bench/spans.kernel_ms), PGGAN's blocks up to
256^2 (models/pggan.apply)."""

from cfr_bench import spans


def read(rec):
    return spans.device_ms(rec, "synthesis.pggan_low")
