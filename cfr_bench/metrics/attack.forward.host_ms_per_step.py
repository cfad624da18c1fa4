"""Host ms per attack step in the forward's layers (the synthesis.prefix,
synthesis.tail, frm and gallery_head spans opened outside the backward)
of the profiled attack."""

from cfr_bench import spans


def read(rec):
    return spans.host_ms_per_step(rec, spans.FORWARD)
