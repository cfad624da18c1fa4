"""The program's own spans, as the span metrics read them: the snapshot
of ``certifyingfacerecognition_torch.utils.profiling``, which records only
while a torch.profiler session does, so in a run only the profiled unit.
A program without spans, a span with no calls or, off the card, no device
intervals or kernels give None, never 0.

The readers of ``metrics/`` that use it (each with a ``.facenet`` copy for
the FaceNet certify cell, or a ``.fabt`` copy for the FAB-t cell):

* ``synthesis_prefix.device_ms``, ``synthesis_tail.device_ms``,
  ``frm.device_ms``, ``gallery_head.device_ms``: median kernel ms of a
  certify batch's ``synthesis.prefix``, ``synthesis.tail``, ``frm`` and
  ``gallery_head`` span (idle stretches of the stream left out);
* ``certify.kernels_per_batch``: the profiled identity's kernels per
  ``certify.batch`` (one MC batch);
* ``attack.kernels_per_step``: the profiled attack's kernels per
  ``attack.step`` (one PGD iterate or FAB iteration);
* ``attack.forward.host_ms_per_step``: host ms of the forward's layer spans
  (outside the backward) per step;
* ``attack.backward.host_ms_per_step``, ``attack.project.host_ms_per_step``:
  host ms of ``attack.backward`` (with the checkpoint's recompute) and
  ``attack.project`` per step."""

from __future__ import annotations

import bisect
import statistics

FORWARD = ("synthesis.prefix", "synthesis.tail", "frm", "gallery_head")
# Kineto floors a Chrome trace's baseTimeNanoseconds, from which its "ts"
# count, to a multiple of this many seconds.
TRACE_BASE_S = 7_889_238


def spans(rec: dict, kind: str):
    """The snapshot's spans by name in a ``kind`` cell's traced run, or
    None."""
    if rec.get("kind") != kind:
        return None
    from certifyingfacerecognition_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    return snapshot() if snapshot is not None else None


def calls(s, name: str) -> int:
    return s[name]["calls"] if s and name in s else 0


def kernel_ms(kernels, s, name: str):
    """Kernel ms of each call of span ``name``: the durations of the
    kernels (the trace's (name, ts us, dur us)) whose midpoint falls
    between the call's device ends, which on one stream are the kernels
    the call launched. The trace's ts count from a base that the
    snapshot's clock reaches by the nearest multiple of TRACE_BASE_S."""
    if not kernels or not calls(s, name) or not s[name]["device_ns"]:
        return None
    mids = sorted(((ts + dur / 2) * 1e3, dur / 1e3) for _, ts, dur in kernels)
    first = min(d0 for v in s.values() for d0, _ in v["device_ns"])
    step = TRACE_BASE_S * 10 ** 9
    base = round((first - mids[0][0]) / step) * step
    at = [m + base for m, _ in mids]
    cum = [0.0]
    for _, ms in mids:
        cum.append(cum[-1] + ms)
    out = [cum[bisect.bisect_right(at, d1)] - cum[bisect.bisect_left(at, d0)]
           for d0, d1 in s[name]["device_ns"]]
    return out if any(out) else None


def device_ms(rec: dict, name: str):
    """Median kernel ms of a call of span ``name`` in the profiled certify
    identity."""
    ms = kernel_ms(rec.get("kernels"), spans(rec, "certify"), name)
    return statistics.median(ms) if ms else None


def kernels_per(rec: dict, kind: str, name: str):
    """Kernels of the profiled unit per call of span ``name``."""
    s = spans(rec, kind)
    if not rec.get("kernels") or not calls(s, name):
        return None
    return len(rec["kernels"]) / calls(s, name)


def host_ms_per_step(rec: dict, names) -> float:
    """Host ms of the spans ``names`` per attack.step of the profiled
    attack."""
    s = spans(rec, "attack")
    if not calls(s, "attack.step") or not any(calls(s, n) for n in names):
        return None
    return sum(s[n]["host_ms"] for n in names if n in s) / calls(
        s, "attack.step")
