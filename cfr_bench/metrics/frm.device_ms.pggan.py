"""``frm.device_ms`` in the PGGAN configuration's certify cell: it moves the
cell's ``certify_samples_per_s``."""

from cfr_bench import harness

read = harness.load_module(
    harness.HERE / "metrics" / "frm.device_ms.py").read
