"""Kernels of the profiled certify identity per certify.batch span: the
launches a batch of samples costs."""

from cfr_bench import spans


def read(rec):
    return spans.kernels_per(rec, "certify", "certify.batch")
