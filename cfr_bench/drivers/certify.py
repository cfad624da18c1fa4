"""Certify driver: randomized smoothing as the certify CLI runs it, one
identity per unit (``Smooth.certify`` over
``FacePipeline.predict_fn_with_params``, fixed N, the selection pass then
the estimation pass, the counts read by the host once per pass).

Traffic keys: sigma (isotropic), n0, n, alpha, batch, identities (latents
drawn in W, each the label of its own gallery row), gallery (rows: the
identities' own embeddings, then filler rows distributed as theirs),
check_batches (MC batches compared with the reference in each run).

The window's batches are marked where the predict function is entered
(a CUDA event, no synchronisation), so a batch's time runs from its mark
to the next one and takes in any host time or stall between them.
"""

from __future__ import annotations

import math
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from cfr_bench import flops, inputs, program
from cfr_bench.reference import pipeline as ref
from cfr_bench.reference.precision import F32, FP8, exact_f32

REF_ROWS = 8                  # reference rows at a time


class Stash:
    """Each MC batch the program runs: a clock mark at its start, and the
    program's perturbations, embeddings and answers. References only: nothing is copied
    or synchronised while the window runs."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.calls = []
        self._embs = None

    def mark(self):
        if not self.on_card:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.on_card else 1e3 * (b - a)

    def wrap_embed(self, fn):
        def embed(gen, frm, w):
            self._embs = fn(gen, frm, w)
            return self._embs
        return embed

    def wrap_predict(self, fn):
        def predict(params, z, p):
            mark = self.mark()
            preds = fn(params, z, p)
            self.calls.append({"mark": mark, "p": p, "preds": preds,
                               "embs": self._embs})
            return preds
        return predict


def setup(ctx) -> SimpleNamespace:
    from certifyingfacerecognition_torch.smoothing.certificate import \
        L2Certificate
    from certifyingfacerecognition_torch.smoothing.smooth import Smooth

    tr, dev, seed = ctx.traffic, ctx.device, ctx.seed
    b = tr["batch"]
    if tr["n0"] % b or tr["n"] % b:
        raise ValueError("n0 and n must be multiples of the batch")
    p = program.build(ctx)
    st = SimpleNamespace(ctx=ctx, tr=tr, p=p, units=[], attempted=0,
                         stash=Stash(dev.type == "cuda"))
    st.z = p.gen.latents(tr["identities"], seed, dev)
    st.z_host = program.to_host(st.z)
    rows = p.gen.pipeline(p).lat2embs(st.z, chunk=b).float()
    xi = torch.randn((tr["gallery"] - tr["identities"], 512), device=dev,
                     generator=inputs.generator(seed, inputs.FILLER, dev))
    st.gallery = torch.cat([rows, program.filler_rows(rows, xi, p.frs)])
    st.pipe = p.gen.pipeline(p, gallery=st.gallery)
    st.pipe.embed_fn = st.stash.wrap_embed(st.pipe.embed_fn)
    fn, params = st.pipe.predict_fn_with_params()
    st.sigma = np.full((5,), tr["sigma"], np.float32)
    st.smoothed = Smooth(st.stash.wrap_predict(fn), tr["gallery"], st.sigma,
                         L2Certificate(), noise_dim=5, batch_size=b,
                         params=params, device=dev)
    st.x = np.zeros((5,), np.float32)
    # warm-up: two batches of the window's own shape
    st.smoothed.certify(st.z_host[0], st.x, 0, b, b, tr["alpha"],
                        inputs.generator(seed, inputs.WARMUP, dev))
    st.stash.calls.clear()
    return st


def run_unit(st, k: int) -> None:
    """Certify identity k (mod the identities drawn), from its own noise
    stream."""
    tr, i = st.tr, k % st.tr["identities"]
    start = len(st.stash.calls)
    gen = inputs.generator(st.ctx.seed, inputs.NOISE + k, st.ctx.device)
    pred, gap = st.smoothed.certify(st.z_host[i], st.x, i, tr["n0"],
                                    tr["n"], tr["alpha"], gen)
    st.units.append({"k": k, "id": i, "start": start,
                     "end": len(st.stash.calls), "pred": pred, "gap": gap})
    st.attempted += 1


def window_metrics(st, seconds: float) -> dict:
    calls = list(st.stash.calls)
    end = st.stash.mark()
    if st.stash.on_card:
        end.synchronize()
    marks = [c["mark"] for c in calls] + [end]
    ms = [st.stash.ms(a, b) for a, b in zip(marks, marks[1:])]
    print(f"window: {len(st.units)} identities, {len(calls)} batches, "
          f"batch ms median {float(np.median(ms))!r}, p95 "
          f"{float(np.percentile(ms, 95))!r}", file=sys.stderr)
    return {"certify_samples_per_s": len(calls) * st.tr["batch"] / seconds,
            "certify_batch_ms_p95": float(np.percentile(ms, 95))}


def layer_record(st) -> dict:
    """Stage timing of one batch (the identities' latents) with CUDA
    events, each stage the previous one plus a step of the pipeline, as
    the generator family splits it (``stages``: the synthesis up to
    256^2, the whole synthesis, the embedding; none where it has no
    split)."""
    p = st.p
    stages = p.gen.stages(p, st.z[:st.tr["batch"]]) or {}
    return {"kind": "certify",
            "stages_ms": {k: stage_ms(st.stash, f) for k, f in stages.items()},
            "batch": st.tr["batch"], "resolution": p.res,
            "flops_per_sample": flops.forward_flops(st.ctx.config,
                                                    st.tr["gallery"])}


def stage_ms(stash, fn, reps: int = 5) -> float:
    """Median device ms of ``fn`` over ``reps`` calls queued back to back,
    after one warm-up call."""
    with torch.inference_mode():
        fn()
        if stash.on_card:
            torch.cuda.synchronize()
        marks = [stash.mark()]
        for _ in range(reps):
            fn()
            marks.append(stash.mark())
        if stash.on_card:
            torch.cuda.synchronize()
    return float(np.median([stash.ms(a, b)
                            for a, b in zip(marks, marks[1:])]))


def release(st) -> None:
    """Free the program's weights and state; its outputs stay."""
    del st.pipe, st.smoothed, st.p.gen_params, st.p.frm_params


def _gallery(st, prec) -> torch.Tensor:
    """The gallery worked out again: the identities' rows and the filler
    rows made from them with the same draws."""
    dev = st.ctx.device
    rows = program.reference_embed(st.p, st.z, prec, REF_ROWS)
    xi = torch.randn((st.tr["gallery"] - st.tr["identities"], 512),
                     device=dev,
                     generator=inputs.generator(st.ctx.seed, inputs.FILLER,
                                                dev))
    return torch.cat([rows, program.filler_rows(rows, xi, st.p.frs)])


def check(st, control: bool = False) -> list:
    """The numbers compared, each with its limit:

    * ``noise_z``: the largest |z-score| of the perturbations' mean and
      variance in each direction, over every batch, against N(0, sigma^2);
    * ``emb_err``: the largest ||e - e_ref|| / ||e_ref|| over the sampled
      batches' embeddings (the reference embeds the program's perturbed
      latents) and the identities' gallery rows;
    * ``pair_err``: within each sampled batch, the largest error of the
      distances between the program's embeddings of two samples, over
      the batch's median reference distance: it sees a batch whose
      samples are not each embedded on their own where ``emb_err``
      cannot, as the perturbations move an embedding less than bf16
      rounding does;
    * ``head_miss``: sampled answers that are not the nearest row of the
      gallery to the program's own embedding, in float64, by more than a
      float32 head's rounding can put them (``ref.head_rounding``);
    * ``cert_miss``: identities whose (prediction, gap) differs from the
      certificate worked out from the program's answers (counts,
      Clopper-Pearson bound, Gaussian quantile), or whose passes have
      another number of batches.

    ``control``: the reference in float8 stands in for the program's
    sampled embeddings, gallery and head (the noise and the certificates
    stay the program's)."""
    exact_f32()
    tr, p = st.tr, st.p
    limits = st.ctx.config["limits"]["certify"]
    n_sel, n_est = tr["n0"] // tr["batch"], tr["n"] // tr["batch"]
    bad_units = set()

    cert_miss = 0
    for u in st.units:
        calls = st.stash.calls[u["start"]:u["end"]]
        preds = [program.to_host(c["preds"]) for c in calls]
        p0 = np.concatenate(preds[:n_sel])
        c_hat = int(np.argmax(np.bincount(p0)))
        want = n_sel + (n_est if c_hat == u["id"] else 0)
        if len(calls) != want:
            cert_miss += 1
            bad_units.add(u["k"])
            continue
        rest = np.concatenate(preds[n_sel:]) if len(preds) > n_sel \
            else np.zeros((0,), np.int64)
        r_pred, r_gap = ref.certificate(p0, rest, u["id"], tr["alpha"])
        if r_pred != u["pred"] or abs(r_gap - u["gap"]) > 1e-9 * max(
                1.0, abs(r_gap)):
            cert_miss += 1
            bad_units.add(u["k"])
    st.selected = sum(u["end"] - u["start"] > n_sel for u in st.units)

    noise = torch.cat([c["p"] for c in st.stash.calls]).double()
    n = noise.shape[0]
    sigma = float(tr["sigma"])
    z_mean = noise.mean(0) / (sigma / math.sqrt(n))
    z_var = (noise.var(0) / sigma ** 2 - 1.0) / math.sqrt(2.0 / (n - 1))
    noise_z = float(torch.cat([z_mean, z_var]).abs().max())

    pairs = [(u, j) for u in st.units for j in range(u["end"] - u["start"])]
    rng = inputs.host_rng(st.ctx.seed, inputs.CHOICE)
    pick = sorted(rng.choice(len(pairs), size=min(tr["check_batches"],
                                                  len(pairs)),
                             replace=False))
    chosen = [st.stash.calls[pairs[i][0]["start"] + pairs[i][1]]
              for i in pick]
    w_ref = torch.cat([
        (st.z[pairs[i][0]["id"]].double() + c["p"].double() @ p.dirs_ref
         ).float() for i, c in zip(pick, chosen)])
    e_ref = program.reference_embed(p, w_ref, F32, REF_ROWS)
    g_ref = _gallery(st, F32)
    if control:
        e_prog = program.reference_embed(p, w_ref, FP8, REF_ROWS)
        g_prog = _gallery(st, FP8)
        preds = ref.nearest(p.frs, e_prog, g_prog, FP8)
    else:
        e_prog = torch.cat([c["embs"] for c in chosen])
        g_prog = st.gallery
        preds = torch.cat([c["preds"] for c in chosen])
    n_ids = tr["identities"]
    rel = torch.cat([program.rel_err(e_prog, e_ref),
                     program.rel_err(g_prog[:n_ids], g_ref[:n_ids])])
    emb_err = float(rel.max())
    pair, spread = pair_err(e_prog, e_ref, tr["batch"])
    st.compared = {"w": w_ref, "e_ref": e_ref}
    st.info = {"emb_err_median": float(rel.median()),
               "pert_spread": spread}

    # the head, judged on what it was given
    d = ref.distances(p.frs, e_prog, g_prog)
    top2 = d.topk(2, dim=1, largest=False).values
    d_ans = d.gather(1, preds[:, None].long())[:, 0]
    over = d_ans - top2[:, 0] > ref.head_rounding(p.frs, e_prog, g_prog,
                                                  d_ans, top2[:, 0])
    head_miss = int(over.sum())
    b = tr["batch"]
    for idx in torch.nonzero(over)[:, 0].tolist():
        bad_units.add(pairs[pick[idx // b]][0]["k"])
    decided = float((top2[:, 1] - top2[:, 0] > ref.head_rounding(
        p.frs, e_prog, g_prog, top2[:, 1], top2[:, 0])).double().mean())
    st.info["head_decided"] = decided
    print(f"check: {len(st.units)} identities, selection met the label "
          f"for {st.selected}; {len(pick)} batches compared "
          f"({w_ref.shape[0]} samples), {100 * decided!r} % of them "
          f"decided beyond a float32 head's rounding; nearest-row margin "
          f"median {float((top2[:, 1] - top2[:, 0]).median())!r}; "
          f"control {control}", file=sys.stderr)
    st.bad_units = bad_units
    out = [{"name": "noise_z", "value": noise_z,
            "limit": limits["noise_z"]},
           {"name": "emb_err", "value": emb_err,
            "limit": limits["emb_err"]},
           {"name": "pair_err", "value": pair, "limit": limits["pair_err"]},
           {"name": "head_miss", "value": head_miss,
            "limit": limits["head_miss"]}]
    if not control:
        out.append({"name": "cert_miss", "value": cert_miss,
                    "limit": limits["cert_miss"]})
    return out


def pair_err(e_prog, e_ref, batch: int):
    """(the largest error of the program's pairwise embedding distances
    within each batch over that batch's median reference distance, the
    largest median reference distance over the median embedding norm: how
    far the batch's perturbations move an embedding)."""
    worst, spread = 0.0, 0.0
    for s in range(0, e_ref.shape[0], batch):
        ep, er = e_prog[s:s + batch].double(), e_ref[s:s + batch].double()
        dp, dr = torch.cdist(ep, ep), torch.cdist(er, er)
        off = ~torch.eye(dr.shape[0], dtype=torch.bool, device=dr.device)
        med = max(float(dr[off].median()), 1e-30)
        worst = max(worst, float((dp - dr).abs().max()) / med)
        spread = max(spread, med / max(float(er.norm(dim=1).median()),
                                       1e-30))
    return worst, spread


def failed(st, checks) -> int:
    return len(st.bad_units)
