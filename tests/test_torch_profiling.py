"""The port's utils/profiling.py, the cases of tests/test_profiling.py
(which holds the JAX package's) that the port keeps, on CPU tensors:
trace writes a trace file (a Chrome/Perfetto JSON whose events name the
span), and measure is >= 0 and subtracts the sync floor. The spans
themselves: tests/test_torch_tracing.py."""

import glob
import json
import os.path as osp

import torch

from certifyingfacerecognition_torch.utils import profiling as P


def test_trace_writes_profile(tmp_path):
    logdir = str(tmp_path / "trace")
    with P.trace(logdir):
        with P.span("frm"):
            torch.square(torch.arange(128.0)).sum()
    files = glob.glob(osp.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1, "no trace artifact written"
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "frm" for e in events)


def test_measure_subtracts_sync_floor():
    """measure() returns ~0 for a trivial op (the floor is subtracted) and
    a positive time for real work."""
    t = P.measure(lambda x: x + 1.0, torch.zeros((8, 128)))
    assert 0.0 <= t < 0.05, t
    t2 = P.measure(lambda x: torch.sin(x).sum(), torch.zeros((2048, 2048)),
                   subtract_sync=False)
    assert t2 > 0.0
    assert P.sync_overhead() >= 0.0
