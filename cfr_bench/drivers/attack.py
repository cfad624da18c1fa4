"""Attack driver: one attack of a chunk of identities per unit, as the
attack CLI runs it: ``find_adversaries_pgd`` (or
``find_adversaries_autoattack``) over ``eval/chunk_runner.make_dists_fn``
(the generator + FRM forward recomputed in the backward), in the
attribute ellipsoid of ``ops/geometry.get_all_matrices``.

Traffic keys: attack (pgd or fab-t) and its settings, batch (identities
per attack), gallery (rows: embeddings of identities drawn in W; the
attacked ones are among them, each the label of its own row), check_calls
(distance calls compared with the reference in each run), check_steps
(PGD first steps recomputed by the reference in each run).
"""

from __future__ import annotations

import sys
import time
from functools import partial
from types import SimpleNamespace

import torch

from cfr_bench import flops, inputs, program
from cfr_bench.reference import pipeline as ref
from cfr_bench.reference.precision import F32, FP8, exact_f32

REF_ROWS = 4                  # reference rows at a time (forward and grad)
EMB = 512.0


def _attack_fn(tr, short: bool = False):
    from certifyingfacerecognition_torch.attacks.autoattack import \
        find_adversaries_autoattack
    from certifyingfacerecognition_torch.attacks.pgd import \
        find_adversaries_pgd

    n = 1 if short else None
    if tr["attack"] == "pgd":
        return partial(find_adversaries_pgd, opt_name=tr["opt"], lr=tr["lr"],
                       iters=n or tr["iters"], restarts=n or tr["restarts"],
                       loss_type=tr["loss"], lin_comb=True)
    return partial(find_adversaries_autoattack, attack_type=tr["attack"],
                   iters=n or tr["iters"], restarts=n or tr["restarts"],
                   n_target_classes=n or tr["n_target_classes"])


def setup(ctx) -> SimpleNamespace:
    tr, dev, seed = ctx.traffic, ctx.device, ctx.seed
    p = program.build(ctx)
    st = SimpleNamespace(ctx=ctx, tr=tr, p=p, units=[], calls=[],
                         attempted=0)
    st.z = p.gen.latents(tr["gallery"], seed, dev)
    rows = p.gen.pipeline(p).lat2embs(st.z, chunk=tr["batch"])
    st.gallery = rows.float().clone()          # autograd saves it
    dists_fn = p.gen.dists_fn(p, remat=True)
    params = {"gen": p.gen_params, "frm": p.frm_params,
              "gallery": st.gallery}

    def dists(w):
        d = dists_fn(params, w)
        st.calls.append((w.detach(), d.detach()))
        return d

    st.dists = dists
    st.attack = _attack_fn(tr)
    # warm-up: the same attack cut to one step, on the first chunk
    _attack_fn(tr, short=True)(dists, *_chunk(st, 0),
                               _cpu_gen(seed, inputs.WARMUP),
                               region=p.region)
    st.calls.clear()
    return st


def _cpu_gen(seed: int, stream: int) -> torch.Generator:
    return torch.Generator().manual_seed(inputs.derive(seed, stream))


def _chunk(st, k: int):
    """(latents, labels) of attack k: the next ``batch`` gallery rows."""
    b, n = st.tr["batch"], st.tr["gallery"]
    ids = torch.arange(k * b, (k + 1) * b, device=st.ctx.device) % n
    return st.z[ids], ids


def run_unit(st, k: int) -> None:
    t0 = time.perf_counter()
    lats, labels = _chunk(st, k)
    start = len(st.calls)
    res = st.attack(st.dists, lats, labels,
                    _cpu_gen(st.ctx.seed, inputs.ATTACK + k),
                    region=st.p.region)
    st.units.append({"k": k, "labels": labels, "start": start,
                     "end": len(st.calls),
                     "deltas": res[0].detach().cpu(),
                     "found": res[1].detach().cpu(),
                     "seconds": time.perf_counter() - t0})
    st.attempted += st.tr["batch"]


def window_metrics(st, seconds: float) -> dict:
    ids = len(st.units) * st.tr["batch"]
    print(f"window: {len(st.units)} attacks, {ids} identities, "
          f"{len(st.calls)} distance calls, "
          f"{sum(int(u['found'].sum()) for u in st.units)} successes, "
          f"seconds per attack {[round(u['seconds'], 3) for u in st.units]}",
          file=sys.stderr)
    return {"attack_ids_per_min": 60.0 * ids / seconds}


def layer_record(st) -> dict:
    tr = st.tr
    steps = tr["restarts"] * tr["iters"] if tr["attack"] == "pgd" else None
    return {"kind": "attack", "attack": tr["attack"], "batch": tr["batch"],
            "steps_per_attack": steps,
            "flops_fwd_per_sample": flops.forward_flops(
                st.ctx.config, tr["gallery"])}


def release(st) -> None:
    del st.dists, st.attack, st.p.gen_params, st.p.frm_params


def _proj_diag(y: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of rows of y onto {x : sum a_i x_i^2 <= 1}
    (float64, bisection on the multiplier)."""
    y, a = y.double(), a.double()
    out = (a * y * y).sum(1) > 1.0
    lo = torch.zeros(y.shape[0], dtype=torch.float64, device=y.device)
    hi = torch.full_like(lo, 1e6)
    for _ in range(200):
        t = 0.5 * (lo + hi)
        f = (a * (y / (1.0 + t[:, None] * a)) ** 2).sum(1) - 1.0
        lo, hi = torch.where(f > 0, t, lo), torch.where(f > 0, hi, t)
    x = y / (1.0 + 0.5 * (lo + hi)[:, None] * a)
    return torch.where(out[:, None], x, y)


def _xent_grad(st, lats, labels, deltas, g_ref, prec) -> torch.Tensor:
    """d loss / d deltas of the attack's loss (the batch mean of minus the
    cross-entropy of softmax(-d / 512) at the label) through the
    reference, row block by row block."""
    p, b = st.p, deltas.shape[0]
    dirs = p.dirs_ref.float()
    grads = []
    for s in range(0, b, REF_ROWS):
        d = deltas[s:s + REF_ROWS].float().clone().requires_grad_(True)
        with torch.enable_grad():
            w = lats[s:s + REF_ROWS].float() + d @ dirs
            e = ref.embed(p.gen, p.gen_sd, p.frm, p.frm_sd, w, p.res, prec,
                          rows=REF_ROWS)
            dist = ref.distances(p.frs, e, g_ref)
            xent = -torch.log_softmax(-dist / EMB, dim=1).gather(
                1, labels[s:s + REF_ROWS, None])[:, 0]
            (g,) = torch.autograd.grad(-xent.sum() / b, d)
        grads.append(g.double())
    return torch.cat(grads)


def _deltas_of(st, w: torch.Tensor, lats: torch.Tensor) -> torch.Tensor:
    """The attribute-space deltas of latents w = lats + delta @ dirs."""
    a = st.p.dirs_ref.t()                               # [512, 5]
    return torch.linalg.lstsq(a, (w.double() - lats.double()).t()
                              ).solution.t()


def check(st, control: bool = False) -> list:
    """The numbers compared, each with its limit:

    * ``emb_err``: the largest ||g - g_ref|| / ||g_ref|| over the gallery;
    * ``dist_err``: the largest |d - d_ref| over the sampled distance
      calls, each row as a share of its mean reference distance;
    * ``delta_excess`` (PGD): the largest sum_i a_i delta_i^2 - 1 in the
      reference's ellipsoid, over every iterate the attack evaluated (its
      latents' deltas) and the deltas it returned;
    * ``step_angle`` (PGD): sampled first steps of a restart, the
      program's step against the reference's projected SGD step from the
      same iterates, 1 - cos of the angle between them over the batch
      (1 for a step that leaves the iterates where they were);
    * ``false_success``: reported successes after which the reference
      still finds the label nearest by more than the distance limit's
      reach, 2 dist_err_limit times the row's mean reference distance.

    ``control``: the reference in float8 stands in for the program's
    gallery, distances, deltas and steps (no successes)."""
    exact_f32()
    tr, p, dev = st.tr, st.p, st.ctx.device
    limits = st.ctx.config["limits"]["attack"]
    pgd = tr["attack"] == "pgd"
    rng = inputs.host_rng(st.ctx.seed, inputs.CHOICE)
    out, bad = [], set()
    st.info = {}

    g_ref = program.reference_embed(p, st.z, F32, REF_ROWS)
    g_prog = (program.reference_embed(p, st.z, FP8, REF_ROWS) if control
              else st.gallery)
    rel = program.rel_err(g_prog, g_ref)
    st.info["emb_err_median"] = float(rel.median())
    out.append({"name": "emb_err", "limit": limits["emb_err"],
                "value": float(rel.max())})

    pick = rng.choice(len(st.calls), size=min(tr["check_calls"],
                                              len(st.calls)), replace=False)
    dist_err = 0.0
    for i in sorted(pick):
        w, d_prog = st.calls[i]
        d_ref = ref.distances(p.frs, program.reference_embed(
            p, w, F32, REF_ROWS), g_ref)
        if control:
            d_prog = ref.distances(p.frs, program.reference_embed(
                p, w, FP8, REF_ROWS), g_prog)
        err = (d_prog.double() - d_ref).abs().max(1).values / d_ref.mean(1)
        dist_err = max(dist_err, float(err.max()))
    out.append({"name": "dist_err", "value": dist_err,
                "limit": limits["dist_err"]})

    a = torch.as_tensor(ref.attribute_ellipse_diag(), device=dev)
    if pgd:
        # every iterate the attack evaluated, and the deltas it returned
        deltas = torch.cat(
            [_deltas_of(st, st.calls[c][0], _chunk(st, u["k"])[0])
             for u in st.units for c in range(u["start"], u["end"])]
            + [u["deltas"].to(dev).double() for u in st.units])
        if control:
            deltas = FP8.q(deltas.float())
        excess = (a * deltas.double() ** 2).sum(1) - 1.0
        out.append({"name": "delta_excess", "value": float(excess.max()),
                    "limit": limits["delta_excess"]})

        step_angle = 0.0
        pairs = [(u, r) for u in st.units for r in range(tr["restarts"])]
        for j in sorted(rng.choice(len(pairs), size=min(
                tr["check_steps"], len(pairs)), replace=False)):
            u, r = pairs[j]
            c0 = u["start"] + r * tr["iters"]
            lats, labels = _chunk(st, u["k"])
            d0 = _deltas_of(st, st.calls[c0][0], lats)
            g = _xent_grad(st, lats, labels, d0, g_ref, F32)
            d1_ref = _proj_diag(d0 - tr["lr"] * g, a)
            if control:
                g = _xent_grad(st, lats, labels, d0, g_prog.detach(), FP8)
                d1 = _proj_diag(d0 - tr["lr"] * g, a)
            else:
                d1 = _deltas_of(st, st.calls[c0 + 1][0], lats)
            s_prog, s_ref = (d1 - d0).flatten(), (d1_ref - d0).flatten()
            den = float(s_prog.norm() * s_ref.norm())
            angle = 1.0 - float(s_prog @ s_ref) / den if den > 0 else 1.0
            step_angle = max(step_angle, angle)
            rel = float((d1 - d1_ref).norm() / s_ref.norm().clamp(min=1e-12))
            st.info.setdefault("step_rel_err", []).append(rel)
            print(f"step check: attack {u['k']} restart {r}: step length "
                  f"median {float((d1_ref - d0).norm(dim=1).median())!r}, "
                  f"1 - cos {angle!r}, relative error {rel!r}",
                  file=sys.stderr)
        out.append({"name": "step_angle", "value": step_angle,
                    "limit": limits["step_angle"]})

    if not control:
        false = 0
        dirs = p.dirs_ref
        for u in st.units:
            found = torch.nonzero(u["found"])[:, 0]
            if not len(found):
                continue
            lats, labels = _chunk(st, u["k"])
            lats, labels = lats[found.to(dev)], labels[found.to(dev)]
            w = (lats.double() + u["deltas"][found].to(dev).double() @ dirs)
            e = program.reference_embed(p, w.float(), F32, REF_ROWS)
            d = ref.distances(p.frs, e, g_ref)
            reach = 2.0 * limits["dist_err"] * d.mean(1)
            own = d.gather(1, labels[:, None])[:, 0]
            d.scatter_(1, labels[:, None], float("inf"))
            n_false = int((d.min(1).values - own > reach).sum())
            false += n_false
            if n_false:
                bad.add(u["k"])
        out.append({"name": "false_success", "value": false,
                    "limit": limits["false_success"]})
    print(f"check: {len(st.units)} attacks, {len(pick)} distance calls "
          f"compared; control {control}", file=sys.stderr)
    st.bad_units = bad
    return out


def failed(st, checks) -> int:
    return len(st.bad_units) * st.tr["batch"]
