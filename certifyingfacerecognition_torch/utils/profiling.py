"""Tracing and phase timing (port of certifyingfacerecognition_tpu/utils/
profiling.py):

  * ``trace(logdir)``: a context manager around torch.profiler that writes
    a Chrome/Perfetto trace (CPU activities, and CUDA kernels on a card)
    under ``logdir``;
  * ``annotate(name)``: a named region (record_function) in that trace;
  * ``PhaseTimer``: accumulating named wall-clock phases with a report,
    each phase synchronised on a result of its own block;
  * ``measure(fn, *args)``: best-of-N time of a call, with CUDA events on
    a card and the host clock on the CPU;
  * ``device_sync(x)``: wait for the device work that produces ``x``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch


def _leaves(x) -> List[torch.Tensor]:
    """The tensors of a nested dict/list/tuple tree."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def _cuda_device(*trees):
    """The device of the first CUDA tensor in ``trees``, else None."""
    for tree in trees:
        for t in _leaves(tree):
            if t.is_cuda:
                return t.device
    return None


def device_sync(x=None) -> None:
    """Wait until the streams of every CUDA device that holds a tensor of
    the tree ``x`` are idle; nothing for CPU tensors."""
    for dev in {t.device for t in _leaves(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def _time_call(fn, args, device) -> float:
    """Seconds of one call of fn(*args), synchronised: CUDA events on
    ``device`` (a CUDA device), else the host clock."""
    if device is None:
        t0 = time.perf_counter()
        device_sync(fn(*args))
        return time.perf_counter() - t0
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3


def sync_overhead(reps: int = 5, device=None) -> float:
    """Seconds of an empty launch and its synchronisation, timed as
    ``measure`` times a call (CUDA events on a card, else the host
    clock): the floor of any timing that ``measure`` takes."""
    x = torch.zeros((8, 128), device=device if device is not None else "cpu")
    return min(_time_call(lambda t: t * 1.0, (x,), device)
               for _ in range(reps + 1))


def measure(fn, *args, reps: int = 5, subtract_sync: bool = True) -> float:
    """Best-of-``reps`` seconds of ``fn(*args)``, after one warm-up call.
    On a card (a CUDA tensor among the arguments or the result) each run
    is timed with CUDA events; on the CPU with the host clock around a
    synchronised call. ``subtract_sync`` subtracts ``sync_overhead``;
    the result is clamped at 0."""
    out = fn(*args)
    device = _cuda_device(args, out)
    device_sync(out)
    best = min(_time_call(fn, args, device) for _ in range(reps))
    if subtract_sync:
        best = max(0.0, best - sync_overhead(device=device))
    return best


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (CPU activities, plus CUDA
    ones when a card is present) and write its Chrome/Perfetto trace to
    ``logdir/<pid>.<time>.pt.trace.json``. Yields the profiler, whose
    ``key_averages()`` and ``events()`` stay readable after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """Named region inside a trace."""
    return torch.profiler.record_function(name)


class _PhaseHandle:
    """Collects the value to synchronise on from INSIDE the timed block:
    a ``sync=`` keyword would be evaluated before the block runs and could
    only ever point at a previous iteration's result."""

    def __init__(self):
        self.value = None

    def sync(self, x):
        self.value = x
        return x


class PhaseTimer:
    """Accumulating wall-clock phase timers.

    Usage::

        timer = PhaseTimer()
        with timer.phase("synthesis") as ph:
            img = ph.sync(synth(w))     # wait for THIS block's result
        logger.info(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        handle = _PhaseHandle()
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            device_sync(handle.value)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = ["phase timings:"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"  {name:24s} {t:8.3f}s ({c}x, "
                         f"{t / c * 1e3:7.1f} ms/call, {100 * t / total:4.1f}%)")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
