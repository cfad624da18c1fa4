"""``certify.kernels_per_batch`` in the PGGAN configuration's certify cell: it moves the
cell's ``certify_samples_per_s``."""

from cfr_bench import harness

read = harness.load_module(
    harness.HERE / "metrics" / "certify.kernels_per_batch.py").read
