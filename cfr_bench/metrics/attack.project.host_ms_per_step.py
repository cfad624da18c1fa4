"""Host ms per attack step in the attack.project span (PGD's projection
onto the ellipsoid; FAB's two hyperplane projections and their norms) of
the profiled attack."""

from cfr_bench import spans


def read(rec):
    return spans.host_ms_per_step(rec, ("attack.project",))
