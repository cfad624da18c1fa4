"""Measurement, weight-conversion and evaluation tools, each run with
``python -m certifyingfacerecognition_torch.tools.<name>``."""
