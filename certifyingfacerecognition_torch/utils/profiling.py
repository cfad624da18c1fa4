"""Tracing and timing (port of certifyingfacerecognition_tpu/utils/
profiling.py), the port's one tracing module:

  * ``trace(logdir)``: a context manager around torch.profiler that writes
    a Chrome/Perfetto trace (CPU activities, and CUDA kernels on a card)
    under ``logdir``, and beside it each span's calls, host and self ms;
  * ``span(name)``: a named layer of the program. With no torch.profiler
    session recording it is one flag check and returns a shared no-op
    context; while a session records, it keeps the span in memory (name,
    parent, host start and end on the trace's clock, and on a card a CUDA
    event at each end, never waited on), and, unless it is an ``outer``
    span, also opens a profiler range, so that the trace names each
    stretch of host time after the layer it was in;
  * ``snapshot()`` / ``reset()``: what the spans recorded, per name
    (calls, host and self ms, and each call's host and device interval
    on the trace's clock), and clearing it;
  * ``measure(fn, *args)``: best-of-N time of a call, with CUDA events on
    a card and the host clock on the CPU;
  * ``device_sync(x)``: wait for the device work that produces ``x``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler


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
    ``logdir/<pid>.<time>.pt.trace.json``, and beside it, as
    ``<pid>.<time>.spans.json``, the calls, host ms and self ms of each
    span the block ran. Yields the profiler, whose ``key_averages()`` and
    ``events()`` stay readable after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    stem = os.path.join(logdir, f"{os.getpid()}.{time.time_ns()}")
    prof.export_chrome_trace(stem + ".pt.trace.json")
    with open(stem + ".spans.json", "w") as f:
        json.dump({name: {k: s[k] for k in ("calls", "host_ms", "self_ms")}
                   for name, s in snapshot().items()}, f, indent=1)
    reset()


class _NoSpan:
    """The one context every span returns while no session records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Call:
    """One recorded span: host times in ns on the trace's clock
    (``time.time_ns``), each taken before the CUDA event at that end is
    recorded (on a card)."""

    __slots__ = ("name", "parent", "t0", "t1", "ev0", "ev1")


class _Recorder:
    """The spans recorded since the last ``reset``."""

    def __init__(self):
        self.calls: List[_Call] = []
        self.local = threading.local()     # .stack, .in_range per thread
        self.exclusive = 0                 # exclusive spans open


_REC = _Recorder()


def _cuda_event() -> Optional[torch.cuda.Event]:
    """A timing event recorded on the current stream, or None off the
    card and while the stream is captured into a CUDA graph."""
    if not torch.cuda.is_initialized() or \
            torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    """A span while a profiler session records."""

    __slots__ = ("name", "outer", "exclusive", "call", "range")

    def __init__(self, name: str, outer: bool, exclusive: bool):
        self.name, self.outer, self.exclusive = name, outer, exclusive
        self.call = self.range = None

    def __enter__(self):
        rec = _REC
        if rec.exclusive:
            # opened inside an exclusive span, on any thread (the
            # checkpoint's recompute runs on the autograd engine's thread
            # on a card): it counts toward that span
            return None
        if self.exclusive:
            rec.exclusive += 1
        local = rec.local
        if not hasattr(local, "stack"):
            local.stack, local.in_range = [], False
        call = _Call()
        call.name = self.name
        call.parent = local.stack[-1] if local.stack else None
        call.t1 = call.ev1 = None
        call.t0 = time.time_ns()
        if not self.outer and not local.in_range:
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
            local.in_range = True
        call.ev0 = _cuda_event()
        local.stack.append(call)
        rec.calls.append(call)
        self.call = call
        return None

    def __exit__(self, *exc):
        call = self.call
        if call is None:
            return False
        if self.range is not None:
            self.range.__exit__(*exc)
            _REC.local.in_range = False
        call.t1 = time.time_ns()
        if call.ev0 is not None:
            call.ev1 = _cuda_event()
        _REC.local.stack.pop()
        if self.exclusive:
            _REC.exclusive -= 1
        return False


def span(name: str, *, outer: bool = False, exclusive: bool = False):
    """The context of the program's layer ``name``. With no torch.profiler
    session recording: one flag check and a shared no-op. While one
    records, the span is kept for ``snapshot`` and opens a profiler range
    of its name, unless it is ``outer`` (it holds other spans; the
    breakdown names an idle gap after the host event overlapping it
    most, which would otherwise be the outer span's), or a range is
    already open on its thread. While an ``exclusive`` span is open no
    other span records, on any thread: what runs inside counts toward it."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, outer, exclusive)


def reset() -> None:
    """Clear what the spans recorded."""
    _REC.calls = []


def device_offset(pairs: List[Tuple[int, int]]) -> int:
    """The ns to add to device times (CUDA events' times from a reference
    event) to put them on the host's clock, from (host ns taken before an
    event was recorded, the event's device ns) pairs: an event completes
    no earlier than the host records it, and one recorded while the
    stream is idle completes a few us later, so the largest difference
    is the offset, to within that latency."""
    return max(h - d for h, d in pairs)


def snapshot() -> Dict:
    """What the spans recorded, by name: ``calls``; ``host_ms`` and
    ``self_ms`` (less the time its child spans cover), summed over the
    calls; ``host_ns``, each call's (start, end) on the trace's clock
    (the Chrome trace's ``ts`` in us plus its ``baseTimeNanoseconds``);
    on a card ``device_ns``, each call's (start, end) on the device: when
    the stream reached the span's CUDA events, on the same clock through
    ``device_offset`` (the card is waited on here). The kernels that run
    between a call's ends are those it launched."""
    calls = [c for c in _REC.calls if c.t1 is not None]
    timed = [c for c in calls if c.ev1 is not None]
    dev = {}
    if timed:
        torch.cuda.synchronize()
        ref = timed[0].ev0
        for c in timed:
            dev[id(c)] = (round(ref.elapsed_time(c.ev0) * 1e6),
                          round(ref.elapsed_time(c.ev1) * 1e6))
        off = device_offset([p for c in timed for p in
                             zip((c.t0, c.t1), dev[id(c)])])
        dev = {k: (d0 + off, d1 + off) for k, (d0, d1) in dev.items()}
    child = {}
    for c in calls:
        if c.parent is not None:
            p = id(c.parent)
            child[p] = child.get(p, 0) + c.t1 - c.t0
    spans: Dict[str, Dict] = {}
    for c in calls:
        s = spans.setdefault(c.name, {"calls": 0, "host_ms": 0.0,
                                      "self_ms": 0.0, "host_ns": [],
                                      "device_ns": []})
        s["calls"] += 1
        s["host_ms"] += (c.t1 - c.t0) / 1e6
        s["self_ms"] += (c.t1 - c.t0 - child.get(id(c), 0)) / 1e6
        s["host_ns"].append((c.t0, c.t1))
        if id(c) in dev:
            s["device_ns"].append(dev[id(c)])
    return spans
