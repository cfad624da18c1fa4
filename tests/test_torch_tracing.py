"""The port's spans (utils/profiling.span) on CPU tensors:

  * with no torch.profiler session a span is the shared no-op: no span
    object, no profiler range, no CUDA event, no synchronisation, and
    nothing recorded;
  * under torch.profiler, a certify batch at 32^2 (StyleGAN, iresnet-18)
    exports a range for each of its range spans, and no program range
    contains another on the same thread;
  * the exported ranges and the snapshot share a clock: the midpoint of
    each range, plus the file's baseTimeNanoseconds, falls inside the
    snapshot's interval of the same call;
  * span counts: Smooth.certify runs N0/B + N/B certify.batch spans; a PGD
    attack restarts x iters attack.step spans, a FAB-t attack targets x
    restarts x iters, each with one attack.backward, and the checkpoint's
    recompute counts toward the backward, not toward the forward's layers;
  * self time, nesting by thread, ``reset`` clearing the record,
    ``trace`` writing each span's calls beside the trace, and the offset
    that puts the spans' device times on the host's clock.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from certifyingfacerecognition_torch.attacks.autoattack import \
    find_adversaries_autoattack
from certifyingfacerecognition_torch.attacks.pgd import find_adversaries_pgd
from certifyingfacerecognition_torch.eval.chunk_runner import make_dists_fn
from certifyingfacerecognition_torch.models import iresnet, stylegan
from certifyingfacerecognition_torch.models.pipeline import FacePipeline
from certifyingfacerecognition_torch.ops import geometry as G
from certifyingfacerecognition_torch.smoothing.certificate import \
    L2Certificate
from certifyingfacerecognition_torch.smoothing.smooth import Smooth
from certifyingfacerecognition_torch.utils import profiling as P

RES, ARCH = 32, "iresnet18"
torch.set_num_threads(1)
# the program's spans: (name, the options it is opened with)
SPANS = {"certify.batch": {"outer": True}, "certify.noise": {},
         "synthesis.prefix": {}, "synthesis.tail": {}, "frm": {},
         "gallery_head": {}, "certify.counts": {}, "certify.read": {},
         "attack.step": {"outer": True},
         "attack.backward": {"exclusive": True}, "attack.project": {},
         "attack.update": {}}
RANGES = {n for n, o in SPANS.items() if not o.get("outer")}


def _profiled(fn, path=None):
    """fn() under torch.profiler (CPU activities), the record reset
    first; (fn's result, the snapshot, the exported trace or None)."""
    P.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    trace = None
    if path is not None:
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            trace = json.load(f)
    return out, P.snapshot(), trace


def _ranges(trace):
    """The program's ranges in an exported trace: (name, tid, start us,
    end us)."""
    return [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"])
            for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("name") in RANGES]


@pytest.fixture(scope="module")
def weights():
    gen = stylegan.random_params(RES, seed=0, device="cpu")
    frm = iresnet.convert_torch_state_dict(
        iresnet.random_torch_style_state_dict(ARCH, seed=0, realistic=True),
        ARCH, device="cpu")
    return gen, frm, G.get_all_matrices(device="cpu")


@pytest.fixture(scope="module")
def certify_case(weights):
    """A Smooth over FacePipeline's predict fn at 32^2: 2 identities whose
    own rows lead a gallery of 6."""
    gen, frm, region = weights
    z = torch.randn((2, 512), generator=torch.Generator().manual_seed(1))
    dirs = region.dirs.t()
    rows = FacePipeline(gen, frm, dirs=dirs, resolution=RES,
                        device="cpu").lat2embs(z)
    far = rows.mean(0) + 10.0 * rows.std(0) * torch.randn(
        (4, 512), generator=torch.Generator().manual_seed(2))
    pipe = FacePipeline(gen, frm, dirs=dirs, resolution=RES,
                        gallery=torch.cat([rows, far]), device="cpu")
    fn, params = pipe.predict_fn_with_params()
    smooth = Smooth(fn, 6, np.full((5,), 0.01, np.float32), L2Certificate(),
                    noise_dim=5, batch_size=2, params=params, device="cpu")
    return smooth, z.numpy()


def test_span_without_profiler_is_the_shared_noop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called with no profiler session")

    P.reset()
    assert not torch.autograd.profiler._is_profiler_enabled
    monkeypatch.setattr(P, "_Span", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    spans = [P.span(name, **o) for name, o in SPANS.items()]
    assert all(s is spans[0] for s in spans)
    for name, o in SPANS.items():
        with P.span(name, **o) as s:
            assert s is None
    assert P.snapshot() == {}


@pytest.mark.parametrize("latency_ns", [0, 3_000])
def test_device_offset_is_set_by_an_idle_stream(latency_ns):
    # events on a device clock 5 s behind the host's; each completes no
    # earlier than the host records it, later behind a queue of work, and
    # the third on an idle stream, latency_ns after its record
    rng = np.random.default_rng(0)
    lag = 5_000_000_000
    host = np.cumsum(rng.integers(10_000, 2_000_000, size=40))
    queue = rng.integers(50_000, 30_000_000, size=40)
    queue[2] = latency_ns
    device = host + queue - lag
    off = P.device_offset(list(zip(host.tolist(), device.tolist())))
    assert off == lag - latency_ns
    assert all(d + off >= h - latency_ns for h, d in zip(host, device))


def test_certify_batch_exports_each_range_without_nesting(certify_case,
                                                          tmp_path):
    smooth, z = certify_case
    x = np.zeros((5,), np.float32)
    (pred, _), spans, trace = _profiled(
        lambda: smooth.certify(z[0], x, 0, 2, 4, 0.1,
                               torch.Generator().manual_seed(3)),
        tmp_path / "certify.json")
    assert pred == 0
    ranges = _ranges(trace)
    want = {"certify.noise", "synthesis.prefix", "synthesis.tail", "frm",
            "gallery_head", "certify.counts", "certify.read"}
    assert {r[0] for r in ranges} == want
    for name in want - {"certify.read"}:
        assert spans[name]["calls"] == 3, name
    assert spans["certify.read"]["calls"] == 2
    assert spans["certify.batch"]["calls"] == 3
    # outer spans are no ranges; no two ranges nest on one thread
    assert "certify.batch" not in {r[0] for r in ranges}
    by_tid = {}
    for name, tid, s, e in ranges:
        by_tid.setdefault(tid, []).append((s, e, name))
    for rs in by_tid.values():
        rs.sort()
        for (s0, e0, n0), (s1, e1, n1) in zip(rs, rs[1:]):
            assert s1 >= e0, f"{n1} inside {n0}"
    # a batch's layers sum to at most its host time
    layers = sum(spans[n]["host_ms"] for n in want - {"certify.read"})
    assert layers <= spans["certify.batch"]["host_ms"]


@pytest.mark.parametrize("n0,n,batch", [(2, 4, 2), (4, 8, 2), (2, 6, 2)])
def test_certify_counts_its_batches(certify_case, n0, n, batch):
    smooth, z = certify_case
    assert smooth.batch_size == batch
    x = np.zeros((5,), np.float32)
    (pred, gap), spans, _ = _profiled(
        lambda: smooth.certify(z[1], x, 1, n0, n, 0.1,
                               torch.Generator().manual_seed(4)))
    assert pred == 1 and gap > 0
    assert spans["certify.batch"]["calls"] == n0 // batch + n // batch
    assert spans["certify.read"]["calls"] == 2


def test_ranges_and_snapshot_share_a_clock(tmp_path):
    def work():
        for name in ("frm", "attack.project", "frm"):
            with P.span("attack.step", outer=True):
                with P.span(name):
                    time.sleep(0.025)

    _, snap, trace = _profiled(work, tmp_path / "clock.json")
    base = trace["baseTimeNanoseconds"]
    seen = {}
    for name, _, s, e in sorted(_ranges(trace), key=lambda r: r[2]):
        k = seen.setdefault(name, 0)
        seen[name] += 1
        t0, t1 = snap[name]["host_ns"][k]
        mid = (s + e) / 2 * 1e3 + base
        assert t0 <= mid <= t1, (name, t0, mid, t1)
    assert seen == {"frm": 2, "attack.project": 1}


def test_self_time_excludes_child_spans():
    def work():
        with P.span("certify.batch", outer=True):
            time.sleep(0.02)
            with P.span("frm"):
                time.sleep(0.03)

    _, snap, _ = _profiled(work)
    b, f = snap["certify.batch"], snap["frm"]
    assert b["host_ms"] >= 50.0 and f["host_ms"] >= 30.0
    assert b["self_ms"] == pytest.approx(b["host_ms"] - f["host_ms"])
    assert f["self_ms"] == f["host_ms"]
    assert b["device_ns"] == [] and f["device_ns"] == []


def test_spans_inside_backward_count_toward_it():
    # the checkpoint's recompute runs on the autograd engine's thread on a
    # card: a span opened there while attack.backward is open is the
    # backward's, and a span on another thread nests on its own stack
    def other_thread(name):
        def run():
            with P.span(name):
                pass

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()

    def work():
        with P.span("attack.step", outer=True):
            with P.span("attack.backward", exclusive=True):
                with P.span("frm"):
                    pass
                other_thread("synthesis.prefix")
        other_thread("gallery_head")

    _, spans, _ = _profiled(work)
    assert set(spans) == {"attack.step", "attack.backward", "gallery_head"}
    assert spans["attack.backward"]["calls"] == 1


def test_reset_clears_the_record():
    def work(name):
        with P.span(name):
            pass

    assert set(_profiled(lambda: work("frm"))[1]) == {"frm"}
    work("frm")                         # no session: nothing recorded
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        work("gallery_head")
    assert set(P.snapshot()) == {"frm", "gallery_head"}
    P.reset()
    assert P.snapshot() == {}


def test_trace_writes_each_spans_calls(tmp_path):
    P.reset()
    with P.trace(str(tmp_path)):
        for _ in range(3):
            with P.span("attack.step", outer=True):
                with P.span("attack.project"):
                    time.sleep(0.002)
    files = list(tmp_path.glob("*.spans.json"))
    assert len(files) == 1 and len(list(tmp_path.glob("*.pt.trace.json")))
    with open(files[0]) as f:
        spans = json.load(f)
    assert set(spans) == {"attack.step", "attack.project"}
    assert spans["attack.project"]["calls"] == 3
    assert spans["attack.step"]["host_ms"] >= spans["attack.project"][
        "host_ms"] >= 6.0
    assert P.snapshot() == {}           # the record ends with the trace


@pytest.fixture(scope="module")
def attack_case(weights):
    gen, frm, region = weights
    """One identity attacked, the first of a gallery of 4."""
    lats = torch.randn((4, 512), generator=torch.Generator().manual_seed(5))
    embed = FacePipeline(gen, frm, dirs=region.dirs.t(), resolution=RES,
                         device="cpu").lat2embs(lats)
    params = {"gen": gen, "frm": frm, "gallery": embed.clone()}
    dists = make_dists_fn("insightface", RES, remat=True)
    return (lambda w: dists(params, w)), lats[:1], torch.arange(1), region


def test_pgd_counts_steps_and_backwards(attack_case):
    dists, lats, labels, region = attack_case
    restarts, iters = 2, 2
    _, spans, _ = _profiled(lambda: find_adversaries_pgd(
        dists, lats, labels, torch.Generator().manual_seed(6), region,
        iters=iters, restarts=restarts))
    steps = restarts * iters
    for name in ("attack.step", "attack.backward", "attack.update",
                 "attack.project"):
        assert spans[name]["calls"] == steps, name
    # one forward a step; the recompute counts toward attack.backward
    for name in ("synthesis.prefix", "synthesis.tail", "frm",
                 "gallery_head"):
        assert spans[name]["calls"] == steps, name


def test_fabt_counts_steps_and_backwards(attack_case):
    dists, lats, labels, region = attack_case
    targets, restarts, iters = 2, 1, 2
    _, spans, _ = _profiled(lambda: find_adversaries_autoattack(
        dists, lats, labels, torch.Generator().manual_seed(7), region,
        "fab-t", iters=iters, restarts=restarts,
        n_target_classes=targets))
    steps = targets * restarts * iters
    assert spans["attack.step"]["calls"] == steps
    assert spans["attack.backward"]["calls"] == steps
    assert spans["attack.project"]["calls"] == steps
    assert spans["attack.update"]["calls"] == 2 * steps
