"""The device's side of a profiled sub-window: kernel intervals from the
profiler's Chrome trace, their union (busy time), kernel time by name and
the longest idle gaps with what the host was doing in each."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")


def events(prof) -> List[dict]:
    """The complete ('X') events of a finished torch.profiler session."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def _union(intervals):
    """Merged (start, end) pairs of sorted intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarise(evs: List[dict], window_s: float) -> Dict:
    """busy_s (union of device intervals), the kernels as (name, start
    us, duration us), the ten device ops with most time and the ten
    longest idle gaps, each named by the host event that overlaps it
    most."""
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    kernels = [(e["name"], float(e["ts"]), float(e["dur"])) for e in dev
               if e.get("cat") == "kernel"]
    merged = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in dev])
    busy_us = sum(e - s for s, e in merged)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:10]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in evs if e.get("cat") in HOST_CATS]
    named_gaps = []
    for length, s, e in gaps:
        best, name = 0.0, "host"
        for hs, he, hn in host:
            ov = min(e, he) - max(s, hs)
            if ov > best:
                best, name = ov, hn
        named_gaps.append([name, length / 1e6])
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "kernels": kernels,
            "device_ops": [[n, t / 1e6] for n, t in top_ops],
            "idle_gaps": named_gaps}
