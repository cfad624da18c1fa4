"""The PGD step's share of the bf16 peak, in %: three times the
reference's forward FLOPs per sample (forward and backward, without the
checkpoint's recompute) times the window's sample-steps per second."""

from cfr_bench import roofline


def read(rec):
    if rec.get("kind") != "attack" or not rec.get("steps_per_attack"):
        return None
    steps_per_s = rec["attack_ids_per_min"] / 60.0 * rec["steps_per_attack"]
    return roofline.share(3.0 * rec["flops_fwd_per_sample"] * steps_per_s,
                          roofline.PEAK_BF16)
