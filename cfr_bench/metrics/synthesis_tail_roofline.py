"""The synthesis tail's share of its roofline, in %: the least time of
the 512^2 and 1024^2 layers' work on one H100 (cfr_bench/roofline.py),
over the tail's measured ms per batch."""

from cfr_bench import roofline


def read(rec):
    s = rec.get("stages_ms", {})
    if "synth" not in s or "pre" not in s or s["synth"] <= s["pre"]:
        return None
    bound_ms, _ = roofline.tail_bound_ms(rec["resolution"], rec["batch"])
    if bound_ms <= 0:
        return None
    return 100.0 * bound_ms / (s["synth"] - s["pre"])
