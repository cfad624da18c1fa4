"""Headline benchmark: Monte-Carlo smoothing throughput (samples/s on one
card) and the attack workload (ids/min) (port of bench.py at the repo
root, the JAX package's headline benchmark).

    python -m certifyingfacerecognition_torch.bench [--device cuda|cpu]
                                                    [--ab FLAG=v1,v2]

BENCH_MODE=mc (default) measures the certification program of one
identity: per batch, draw the noise, perturb the latent (w = z + p @ dirs),
synthesize (StyleGAN, BENCH_RESOLUTION), embed (ArcFace iresnet-50, or
FaceNet), find the exact nearest gallery identity and count the classes
(smoothing/smooth._make_batch_fn), over BENCH_NBATCHES batches of
BENCH_BATCH; one warm-up run, then three timed runs. BENCH_MODE=attack
measures ids/min through PGD (BENCH_ATTACK=pgd: SGD, lr 1e2, 5 restarts x
5 iterations, xent) or FAB-t (BENCH_ATTACK=fab-t: 2 restarts x 5
iterations x 2 targets) on BENCH_BATCH_ATTACK identities, against a
gallery of the identities' own embeddings. Each mode prints one JSON line
with bench.py's keys and ``device``: the card's name and power limit as
nvidia-smi reports them, or "cpu".

Weights are random and made from seed 0 (throughput does not depend on
them): StyleGAN at full width, and ArcFace iresnet-50 from
iresnet.random_torch_style_state_dict(realistic=True), whose He-scaled
convolutions keep the activations finite. The JAX bench's default ArcFace
weights (realistic=False) drive every embedding to NaN, in both packages,
so its nearest identities are arbitrary. bf16 (BENCH_DTYPE, default) runs
the hand-written synthesis tail when CFR_TAIL=bc; CFR_TAIL and
CFR_TAIL_MIN_RES are read when a measurement builds its program, so
``--ab`` can toggle them between measurements of one process. An empty
value unsets the flag (``--ab CFR_TAIL=,bc``): each value's JSON line and
a summary line are printed, and both are written to bench_ab_<FLAG>.json
in the working directory. ``--ab`` measures the mc mode, as bench.py's.

BENCH_MESH_ID > 1 splits the gallery rows over that many ranks of a
torch.distributed group (parallel/gallery.py) and the MC batch over the
rest, as ``cfr-certify-torch --mesh --mesh-id``; the group comes from
torchrun's environment (one process per device). Every rank draws the
whole gallery and keeps its block; rank 0 prints.

``--device`` defaults to cuda and raises without a card; ``--device cpu``
runs the same program on the CPU (the tests do, at 32^2).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from .attacks.autoattack import find_adversaries_autoattack
from .attacks.pgd import find_adversaries_pgd
from .eval.chunk_runner import make_dists_fn
from .models import facenet, iresnet, stylegan
from .models.pipeline import make_lat2embs
from .ops import distances as D
from .ops import geometry as G
from .parallel.gallery import make_sharded_gallery_predict_fn, shard_rows
from .parallel.mesh import init_distributed, make_mesh
from .smoothing.certificate import L2Certificate
from .smoothing.smooth import _make_batch_fn
from .utils.device import device_label, f32_exact_math, resolve_device
from .utils.profiling import device_sync

BASELINE_SAMPLES_PER_SEC = 33.0
# the attack baselines (the reference's RTX 3090 runs, chunks of 20 ids):
# PGD 5 x 5 in ~1 min, FAB-t 2 x 5 x 2 targets in ~1.5 min
BASELINE_PGD_IDS_PER_MIN = 20.0
BASELINE_FABT_IDS_PER_MIN = 20 / 1.5
EMBED_BATCH = 128                 # the attack gallery's embedding chunks
# the reference's worked examples: PGD --iters 5 --restarts 5, FAB-t
# --iters 5 --restarts 2 --n-target-classes 2
PGD_KWARGS = dict(opt_name="SGD", lr=1e2, iters=5, restarts=5,
                  loss_type="xent", lin_comb=True)
FABT_KWARGS = dict(attack_type="fab-t", iters=5, restarts=2,
                   n_target_classes=2)


def _env_dtype() -> torch.dtype:
    return torch.bfloat16 if os.environ.get("BENCH_DTYPE", "bf16") == \
        "bf16" else torch.float32


def _models(resolution: int, frs: str, device):
    """(StyleGAN params, FRM params) at full width, from seed 0."""
    gen_params = stylegan.random_params(resolution, seed=0, device=device)
    if frs == "insightface":
        frm_params = iresnet.convert_torch_state_dict(
            iresnet.random_torch_style_state_dict("iresnet50", seed=0,
                                                  realistic=True),
            device=device)
    else:
        frm_params = facenet.random_params(seed=0, device=device)
    return gen_params, frm_params


def make_mc_run(device="cuda", gallery=None):
    """Build the mc program from the environment (BENCH_*, CFR_*): a
    function run(seed, noise=None) -> per-class counts [BENCH_GALLERY] (f32
    on the device) of BENCH_NBATCHES batches, whose noise comes from a
    generator seeded with ``seed`` or, when given, from ``noise``
    [n_batches, batch, 5]. ``gallery`` [BENCH_GALLERY, 512], when given,
    replaces the gallery drawn on the device. Returns (run, samples per
    run)."""
    resolution = int(os.environ.get("BENCH_RESOLUTION", "1024"))
    frs = os.environ.get("BENCH_FRS", "insightface")
    batch = int(os.environ.get("BENCH_BATCH", "128"))
    n_batches = int(os.environ.get("BENCH_NBATCHES", "10"))
    n_gallery = int(os.environ.get("BENCH_GALLERY", "1000"))
    mesh_id = int(os.environ.get("BENCH_MESH_ID", "1"))
    dtype = _env_dtype()

    dev = resolve_device(device)
    if mesh_id > 1 and not dist.is_initialized():
        dev = init_distributed(device=dev)
    if dtype == torch.float32:
        f32_exact_math()
    gen_params, frm_params = _models(resolution, frs, dev)
    rng = np.random.default_rng(0)
    # drawn on the device: the 1M-identity regime is a 2 GB gallery
    if gallery is None:
        gallery = torch.randn((n_gallery, 512), device=dev,
                              generator=torch.Generator(dev).manual_seed(123))
    else:
        gallery = torch.as_tensor(gallery, dtype=torch.float32, device=dev)
    dirs = torch.as_tensor(np.linalg.qr(rng.standard_normal((512, 5)))[0]
                           [:, :5].T, dtype=torch.float32, device=dev)
    embed = make_lat2embs(frs, resolution, dtype=dtype)
    params = {"gen": gen_params, "frm": frm_params, "dirs": dirs}

    mesh = None
    if mesh_id > 1:
        mesh = make_mesh(mesh_id)
        lo, hi = shard_rows(n_gallery, mesh_id, mesh.id)
        params["gallery"] = gallery[lo:hi].clone()
        del gallery
        predict_fn = make_sharded_gallery_predict_fn(embed, mesh.id_group,
                                                     lo, frs)
    else:
        params["gallery"] = gallery

        def predict_fn(params, z, p):
            with torch.inference_mode():
                w = z[None, :] + G.matmul_f32(p, params["dirs"])
                embs = embed(params["gen"], params["frm"], w).float()
                return D.argmin_dist_refined(embs, params["gallery"], frs)

    batch_fn = _make_batch_fn(predict_fn, n_gallery, L2Certificate(), batch,
                              5, dev, with_params=True, mesh=mesh)
    z = torch.as_tensor(rng.standard_normal(512), dtype=torch.float32,
                        device=dev)
    x = torch.zeros((5,), dtype=torch.float32, device=dev)
    sigma = torch.tensor(0.1, dtype=torch.float32, device=dev)

    def run(seed: int, noise=None) -> torch.Tensor:
        gen = torch.Generator(dev).manual_seed(seed)
        counts = torch.zeros((n_gallery,), dtype=torch.float32, device=dev)
        for i in range(n_batches):
            counts += batch_fn(params, z, x, sigma, gen, batch,
                               None if noise is None else noise[i])
        return counts

    return run, n_batches * batch


def measure(reps: int = 3, device="cuda"):
    """Run the mc benchmark once under the current environment: a warm-up
    run, then ``reps`` timed runs. Each call builds its program anew, so
    callers may change os.environ between calls to compare settings in one
    process."""
    run, per_run = make_mc_run(device)
    device_sync(run(0))                           # warm up
    t0 = time.perf_counter()
    for r in range(1, reps + 1):
        counts = run(r)
    device_sync(counts)
    dt = time.perf_counter() - t0
    if int(counts.sum()) != per_run:
        raise RuntimeError(f"a run counted {int(counts.sum())} samples, not "
                           f"{per_run}")

    sps = reps * per_run / dt
    return {
        "metric": "mc_smoothing_samples_per_sec_per_chip",
        "value": round(sps, 2),
        "unit": "samples/s",
        "vs_baseline": round(sps / BASELINE_SAMPLES_PER_SEC, 2),
        "device": device_label(counts.device),
    }


def attack_gallery(gen_params, frm_params, frs: str, resolution: int,
                   dtype, n_gallery: int, device):
    """The attack mode's identities and gallery: ``n_gallery`` latents z
    (numpy seed 0, scaled to norm sqrt(512)) through the mapping, and their
    embeddings in chunks of EMBED_BATCH, the ragged last chunk zero-padded.
    Returns (w [n_gallery, 512], gallery [n_gallery, 512] f32), both plain
    tensors: the attack differentiates against the gallery."""
    rng = np.random.default_rng(0)
    z = rng.standard_normal((n_gallery, 512)).astype(np.float32)
    z = z / np.linalg.norm(z, axis=1, keepdims=True) * np.sqrt(512)
    embed = make_lat2embs(frs, resolution, dtype=dtype)
    with torch.no_grad():
        w_all = stylegan.mapping_apply(gen_params,
                                       torch.as_tensor(z, device=device))
        parts = []
        for s in range(0, n_gallery, EMBED_BATCH):
            chunk = w_all[s:s + EMBED_BATCH]
            n = chunk.shape[0]
            if n < EMBED_BATCH:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (EMBED_BATCH - n, 512))])
            parts.append(embed(gen_params, frm_params, chunk).float()[:n])
    return w_all, torch.cat(parts)


def measure_attack(reps: int = 3, device="cuda"):
    """The attack benchmark (BENCH_MODE=attack): identities per minute
    through PGD or FAB-t, with the attack CLI's distances (the generator +
    FRM forward recomputed in the backward, make_dists_fn's remat). A
    warm-up attack, then ``reps`` timed ones, each with a generator of its
    own seed."""
    resolution = int(os.environ.get("BENCH_RESOLUTION", "1024"))
    frs = os.environ.get("BENCH_FRS", "insightface")
    attack = os.environ.get("BENCH_ATTACK", "pgd")
    batch = int(os.environ.get("BENCH_BATCH_ATTACK", "20"))
    n_gallery = int(os.environ.get("BENCH_GALLERY", "1000"))
    dtype = _env_dtype()
    if attack == "pgd":
        attack_fn = partial(find_adversaries_pgd, **PGD_KWARGS)
        baseline, metric = BASELINE_PGD_IDS_PER_MIN, "pgd_attack_ids_per_min"
    elif attack == "fab-t":
        attack_fn = partial(find_adversaries_autoattack, **FABT_KWARGS)
        baseline, metric = BASELINE_FABT_IDS_PER_MIN, \
            "fabt_attack_ids_per_min"
    else:
        raise SystemExit(f"BENCH_ATTACK must be pgd or fab-t (got {attack})")
    if batch > n_gallery:
        raise SystemExit(f"BENCH_BATCH_ATTACK {batch} exceeds BENCH_GALLERY "
                         f"{n_gallery}: the attacked identities are the "
                         f"gallery's first rows")

    dev = resolve_device(device)
    if dtype == torch.float32:
        f32_exact_math()
    gen_params, frm_params = _models(resolution, frs, dev)
    region = G.get_all_matrices(device=dev)
    w_all, gallery = attack_gallery(gen_params, frm_params, frs, resolution,
                                    dtype, n_gallery, dev)
    dists_fn = make_dists_fn(frs, resolution, dtype)
    params = {"gen": gen_params, "frm": frm_params, "gallery": gallery}
    lats = w_all[:batch]
    labels = torch.arange(batch, device=dev)

    def step(seed):
        return attack_fn(partial(dists_fn, params), lats, labels,
                         torch.Generator().manual_seed(seed), region=region)

    device_sync(step(0))                          # warm up
    t0 = time.perf_counter()
    for r in range(1, reps + 1):
        out = step(r)
    device_sync(out)
    dt = (time.perf_counter() - t0) / reps

    ids_per_min = 60.0 * batch / dt
    return {
        "metric": metric,
        "value": round(ids_per_min, 2),
        "unit": "ids/min",
        "vs_baseline": round(ids_per_min / baseline, 2),
        "device": device_label(dev),
    }


def _is_writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _run_ab(spec: str, reps: int = 3, device="cuda"):
    """Same-session A/B over an env flag: ``FLAG=v1,v2[,...]`` (mc mode).
    Returns the summary."""
    flag, _, values = spec.partition("=")
    if not values:
        raise SystemExit(f"--ab needs FLAG=v1,v2 (got {spec!r})")
    results = []
    for val in values.split(","):
        if val == "":
            os.environ.pop(flag, None)
        else:
            os.environ[flag] = val
        row = measure(reps=reps, device=device)
        row["env"] = {flag: val or None}
        results.append(row)
        if _is_writer():
            print(json.dumps(row), flush=True)
    base = results[0]["value"]
    summary = {
        "ab_flag": flag,
        "values": [r["env"][flag] for r in results],
        "samples_per_sec": [r["value"] for r in results],
        "ratio_vs_first": [round(r["value"] / base, 4) for r in results],
        "bench_env": {k: v for k, v in os.environ.items()
                      if k.startswith(("BENCH_", "CFR_"))},
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "device": results[0]["device"],
    }
    if _is_writer():
        print(json.dumps(summary), flush=True)
        out = f"bench_ab_{flag}.json"
        with open(out, "w") as f:
            json.dump({"runs": results, "summary": summary}, f, indent=1)
        print(f"# persisted -> {out}", flush=True)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ab", metavar="FLAG=v1,v2", default=None,
                    help="measure each env-flag value in one session and "
                         "persist the pair to bench_ab_<FLAG>.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    mode = os.environ.get("BENCH_MODE", "mc")
    if args.ab:
        _run_ab(args.ab, device=args.device)
    elif mode == "attack":
        print(json.dumps(measure_attack(device=args.device)))
    elif mode == "mc":
        row = measure(device=args.device)
        if _is_writer():
            print(json.dumps(row))
    else:
        raise SystemExit(f"BENCH_MODE must be mc or attack (got {mode})")


if __name__ == "__main__":
    main()
