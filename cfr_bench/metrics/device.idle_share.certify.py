"""Share of the profiled certify unit, in %, in which no operation ran on the
device: 1 - (union of kernel, copy and set intervals) / host span."""


def read(rec):
    if rec.get("kind") != "certify" or rec.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
