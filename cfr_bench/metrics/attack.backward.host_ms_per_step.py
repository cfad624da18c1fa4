"""Host ms per attack step in the attack.backward span (the gradient,
with the checkpoint's recompute) of the profiled attack."""

from cfr_bench import spans


def read(rec):
    return spans.host_ms_per_step(rec, ("attack.backward",))
