"""synthesis.pggan_high's share of its roofline, in %: the least time of
the 512^2 and 1024^2 layers' and the ToRGB head's work at the cell's
batch on one H100 (the generator family's ``high_bound_ms``, each layer's
input, weights and output once in bf16), over the span's measured kernel
ms a batch (``pggan_high.device_ms``)."""

from cfr_bench import families, spans


def read(rec):
    ms = spans.device_ms(rec, "synthesis.pggan_high")
    if not ms or "resolution" not in rec:
        return None
    gen = families.load("generator", "progan_celebahq")
    return 100.0 * gen.high_bound_ms(rec["resolution"], rec["batch"]) / ms
