"""Kernels of the profiled attack per attack.step span (a PGD iterate, a
FAB iteration)."""

from cfr_bench import spans


def read(rec):
    return spans.kernels_per(rec, "attack", "attack.step")
