"""``gallery_head.device_ms`` in the FaceNet configuration's certify
cells: it moves that configuration's ``certify_samples_per_s.facenet``."""

from cfr_bench import harness

read = harness.load_module(
    harness.HERE / "metrics" / "gallery_head.device_ms.py").read
