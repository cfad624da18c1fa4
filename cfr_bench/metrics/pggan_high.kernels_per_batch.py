"""Kernels a call of synthesis.pggan_high launches, over the profiled
certify identity's calls: the trace's kernels whose midpoint falls in
the call's device interval, attributed as cfr_bench/spans.kernel_ms
attributes kernel time (each kernel given 1 us at its midpoint, so that
a call's kernel ms x 1000 is its count). The launches a fused kernel
would take away."""

import statistics

from cfr_bench import spans

SPAN = "synthesis.pggan_high"


def read(rec):
    kernels = rec.get("kernels")
    if not kernels:
        return None
    unit = [(name, ts + dur / 2 - 0.5, 1.0) for name, ts, dur in kernels]
    per_call = spans.kernel_ms(unit, spans.spans(rec, "certify"), SPAN)
    if per_call is None:
        return None
    return statistics.mean(round(1e3 * ms) for ms in per_call)
