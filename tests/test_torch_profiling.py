"""The port's utils/profiling.py, the four cases of tests/test_profiling.py
(which holds the JAX package's) on CPU tensors: PhaseTimer accumulates and
reports, a phase's handle holds its own block's result, trace writes a
trace file (a Chrome/Perfetto JSON whose events name the annotated
region), and measure is >= 0 and subtracts the sync floor."""

import glob
import json
import os.path as osp
import time

import torch

from certifyingfacerecognition_torch.utils import profiling as P


def test_phase_timer_accumulates_and_reports():
    t = P.PhaseTimer()
    for _ in range(3):
        with t.phase("work"):
            time.sleep(0.01)
    with t.phase("other"):
        time.sleep(0.005)
    assert t.counts["work"] == 3 and t.counts["other"] == 1
    assert t.totals["work"] >= 0.03
    rep = t.report()
    assert "work" in rep and "3x" in rep and "%" in rep
    t.reset()
    assert not t.totals


def test_phase_timer_sync_pulls_block_result():
    t = P.PhaseTimer()
    with t.phase("compute") as ph:
        r = ph.sync(torch.arange(4).sum())
    assert int(r) == 6 and ph.value is r
    assert t.counts["compute"] == 1


def test_trace_writes_profile(tmp_path):
    logdir = str(tmp_path / "trace")
    with P.trace(logdir):
        with P.annotate("phase-x"):
            torch.square(torch.arange(128.0)).sum()
    files = glob.glob(osp.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1, "no trace artifact written"
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "phase-x" for e in events)


def test_measure_subtracts_sync_floor():
    """measure() returns ~0 for a trivial op (the floor is subtracted) and
    a positive time for real work."""
    t = P.measure(lambda x: x + 1.0, torch.zeros((8, 128)))
    assert 0.0 <= t < 0.05, t
    t2 = P.measure(lambda x: torch.sin(x).sum(), torch.zeros((2048, 2048)),
                   subtract_sync=False)
    assert t2 > 0.0
    assert P.sync_overhead() >= 0.0
