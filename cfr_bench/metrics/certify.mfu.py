"""The certify step's share of the bf16 peak, in %: the reference's model
FLOPs per sample times the window's certified samples per second."""

from cfr_bench import roofline


def read(rec):
    if rec.get("kind") != "certify":
        return None
    return roofline.share(rec["flops_per_sample"]
                          * rec["certify_samples_per_s"], roofline.PEAK_BF16)
