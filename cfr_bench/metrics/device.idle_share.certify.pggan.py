"""``device.idle_share.certify`` in the PGGAN configuration's certify cell: it moves the
cell's ``certify_samples_per_s``."""

from cfr_bench import harness

read = harness.load_module(
    harness.HERE / "metrics" / "device.idle_share.certify.py").read
