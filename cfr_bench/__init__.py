"""Benchmark of certifyingfacerecognition_torch on one H100: the cells of
BENCHMARK.json, a plain-PyTorch reference that decides ``correct``, and
the readers of the per-layer metrics. See README.md."""
