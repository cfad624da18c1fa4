"""Weak-scaling scan of the sharded MC-counts program (port of
certifyingfacerecognition_tpu/tools/weak_scaling.py).

Runs the counts program (noise -> perturb -> synthesis -> embed -> argmin
-> count -> all-reduce: ``Smooth._counts`` with a parallel/mesh.Mesh)
over 1, 2, 4, 8 ranks at a fixed batch per rank and reports, per rank
count:

  * FLOPs per rank per sample, counted by torch.utils.flop_counter.
    FlopCounterMode on rank 0 over one run of the program: ideal weak
    scaling keeps it constant. The counter counts matrix products and
    convolutions only; XLA's cost analysis, which the JAX tool reads, also
    counts elementwise work, so the two tools' absolute numbers differ;
  * the collectives that the program issues, recorded on rank 0 by
    wrapping torch.distributed's collective functions for that run (kind,
    bytes of the result), per batch. The JAX tool reads its inventory from
    the optimized HLO, which has no counterpart here;
  * wall-clock samples/s and the derived efficiency. With at least as many
    cores as ranks, ``parallel_efficiency`` = t_1 / t_n is the classic
    weak-scaling number; with fewer, the ranks timeshare and the honest
    statement is work conservation, n t_1 / t_n (``wallclock_semantics``
    says which applies).

One rank runs in this process with no mesh and no collective. n > 1
ranks are n processes over torch.distributed: gloo on the CPU, NCCL on
cuda with rank r on cuda:r (so n may not exceed the GPU count); each
holds the program at batch n x per-rank batch and classifies its slice.

Weights: StyleGAN random:0 and ArcFace iresnet-50 random:0, f32 (plain
PyTorch ops; no chain kernel runs).

Usage: python -m certifyingfacerecognition_torch.tools.weak_scaling
Env knobs: WS_PER_DEV_BATCH (default 8), WS_NBATCHES (4), WS_RESOLUTION
(64), WS_GALLERY (200), WS_DEVICES (comma list of rank counts, default
"1,2,4,8"). ``--device`` (default cuda; cpu runs gloo ranks).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

# torch.distributed's collectives; the result is each one's first argument
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
                "all_to_all_single", "broadcast")
_ROOT = Path(__file__).resolve().parents[2]
TIMEOUT = 600           # seconds each rank process may take


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return sum(_nbytes(t) for t in x)


@contextlib.contextmanager
def record_collectives():
    """Record (kind, bytes of the result) of every torch.distributed
    collective called in the block; yields the list."""
    log = []
    saved = {name: getattr(dist, name) for name in _COLLECTIVES}

    def recorded(name, fn):
        def call(result, *args, **kwargs):
            log.append((name, _nbytes(result)))
            return fn(result, *args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, recorded(name, fn))
    try:
        yield log
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _counts_program(batch: int, n_batches: int, resolution: int,
                    n_gallery: int, device, mesh=None):
    """fn() -> counts [n_gallery]: one run of the counts program over
    ``n_batches`` batches of ``batch`` samples (with a mesh, this rank
    classifies its slice of each batch and the counts are all-reduced)."""
    from ..models import iresnet, stylegan
    from ..models.pipeline import make_lat2embs
    from ..ops import distances as D
    from ..smoothing.certificate import L2Certificate
    from ..smoothing.smooth import Smooth
    from ..utils.device import f32_exact_math

    f32_exact_math()
    gen_params = stylegan.random_params(resolution, seed=0, device=device)
    frm_params = iresnet.convert_torch_state_dict(
        iresnet.random_torch_style_state_dict("iresnet50", seed=0),
        device=device)
    rng = np.random.default_rng(0)
    gallery = torch.as_tensor(rng.standard_normal((n_gallery, 512)),
                              dtype=torch.float32, device=device)
    dirs = torch.as_tensor(np.linalg.qr(
        rng.standard_normal((512, 5)))[0][:, :5].T, dtype=torch.float32,
        device=device)
    embed = make_lat2embs("insightface", resolution, dtype=torch.float32)

    def predict_fn(params, z, p):
        gp, fp = params
        with torch.inference_mode():
            w = z[None, :] + p @ dirs
            embs = embed(gp, fp, w).float()
            return D.argmin_dist_refined(embs, gallery, "insightface")

    smooth = Smooth(predict_fn, n_gallery, 0.1, L2Certificate(),
                    noise_dim=5, batch_size=batch,
                    params=(gen_params, frm_params), device=device,
                    mesh=mesh)
    z, x = smooth._inputs(rng.standard_normal(512), np.zeros(5))
    valid = np.full((n_batches,), batch, np.int64)

    def run():
        gen = torch.Generator(device=smooth.device).manual_seed(0)
        return smooth._counts(z, x, valid, gen)

    return run


def _scan_rank(n: int, per_dev_batch: int, n_batches: int, resolution: int,
               n_gallery: int, time_it: bool, device, mesh=None) -> dict:
    """This rank's row of the scan at ``n`` ranks (every rank of the group
    calls it: the program's all-reduce needs them all)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..utils.device import device_name
    from ..utils.profiling import device_sync

    run = _counts_program(n * per_dev_batch, n_batches, resolution,
                          n_gallery, device, mesh)
    with FlopCounterMode(display=False) as flops, \
            record_collectives() as log:
        device_sync(run())
    per_batch = collections.Counter(log)
    if any(c % n_batches for c in per_batch.values()):
        raise AssertionError(f"collectives not a multiple of the "
                             f"{n_batches} batches: {log}")
    coll = [{"kind": k, "bytes": b}
            for (k, b), c in per_batch.items() for _ in range(c // n_batches)]
    row = {
        "devices": n,
        "batch": n * per_dev_batch,
        "per_device_batch": per_dev_batch,
        "flops_per_device_per_sample": round(
            flops.get_total_flops() / (n_batches * per_dev_batch)),
        "collectives": coll,
        "collective_bytes_per_batch": sum(c["bytes"] for c in coll),
        "device": device_name(device),
    }
    if time_it:
        device_sync(run())
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            c = run()
        device_sync(c)
        dt = (time.perf_counter() - t0) / reps
        row["wall_s_per_scan"] = round(dt, 4)
        row["samples_per_s"] = round(n_batches * n * per_dev_batch / dt, 1)
    return row


def _rank_main(cfg: dict) -> None:
    """One rank of a multi-rank scan (a process of its own); rank 0
    prints the row as a JSON line."""
    from ..parallel.mesh import init_distributed, make_mesh

    if cfg["device"] == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // cfg["world"]))
    dev = init_distributed(cfg["address"], cfg["world"], cfg["rank"],
                           cfg["device"])
    try:
        row = _scan_rank(cfg["world"], cfg["per_dev_batch"],
                         cfg["n_batches"], cfg["resolution"],
                         cfg["n_gallery"], cfg["time_it"], dev, make_mesh())
        if cfg["rank"] == 0:
            print(json.dumps(row), flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_scan(n: int, cfg: dict, timeout: float) -> dict:
    """Rank 0's row from ``n`` rank processes; every process is killed if
    one outlasts ``timeout`` seconds."""
    address = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(_ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for r in range(n):
        arg = json.dumps(dict(cfg, address=address, world=n, rank=r))
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             "import sys, json; from certifyingfacerecognition_torch.tools."
             "weak_scaling import _rank_main; _rank_main(json.loads("
             "sys.argv[1]))", arg],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"weak_scaling rank {r} of {n} failed "
                               f"({p.returncode}):\n{err[-4000:]}")
    lines = [ln for ln in outs[0][0].splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def run_scan(device_counts=None, per_dev_batch=None, n_batches=None,
             resolution=None, n_gallery=None, time_it=True, device="cuda",
             timeout=TIMEOUT):
    """One result dict per rank count (see the module docstring)."""
    from ..utils.device import resolve_device

    device_counts = device_counts or [
        int(d) for d in os.environ.get("WS_DEVICES", "1,2,4,8").split(",")]
    per_dev_batch = per_dev_batch or int(
        os.environ.get("WS_PER_DEV_BATCH", "8"))
    n_batches = n_batches or int(os.environ.get("WS_NBATCHES", "4"))
    resolution = resolution or int(os.environ.get("WS_RESOLUTION", "64"))
    n_gallery = n_gallery or int(os.environ.get("WS_GALLERY", "200"))
    dev = resolve_device(device)
    if dev.type == "cuda" and max(device_counts) > torch.cuda.device_count():
        raise ValueError(
            f"weak_scaling: {max(device_counts)} ranks need as many GPUs "
            f"(NCCL puts no two ranks on one GPU); this host has "
            f"{torch.cuda.device_count()}")
    cfg = dict(per_dev_batch=per_dev_batch, n_batches=n_batches,
               resolution=resolution, n_gallery=n_gallery, time_it=time_it,
               device=dev.type)
    ncores = os.cpu_count() or 1

    results = []
    for n in device_counts:
        if n == 1:
            results.append(_scan_rank(1, per_dev_batch, n_batches,
                                      resolution, n_gallery, time_it, dev))
        else:
            results.append(_spawn_scan(n, cfg, timeout))

    if time_it:
        t1 = results[0]["wall_s_per_scan"]
        for row in results:
            n = row["devices"]
            if ncores >= n:
                row["parallel_efficiency"] = round(
                    t1 / row["wall_s_per_scan"], 3)
                row["wallclock_semantics"] = "parallel (cores >= ranks)"
            else:
                row["work_conservation"] = round(
                    n * t1 / row["wall_s_per_scan"], 3)
                row["wallclock_semantics"] = (
                    f"timeshared ({ncores} core(s) < {n} ranks): "
                    "work conservation, not parallel speedup")
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"], help="cuda needs a CUDA GPU "
                   "per rank")
    args = p.parse_args(argv)
    for row in run_scan(device=args.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
