"""``attack.backward.host_ms_per_step`` in the FAB-t cells: it moves their own
``attack_ids_per_min.fabt``."""

from cfr_bench import harness

read = harness.load_module(
    harness.HERE / "metrics" / "attack.backward.host_ms_per_step.py").read
