"""Certification CLI (port of certifyingfacerecognition_tpu/cli/certify.py):
randomized-smoothing certification of identities, with a fixed Monte-Carlo
budget or early stopping (--adaptive), at the native or a reduced
synthesis resolution (--synthesis-resolution, --cascade), on one CUDA
device by default (--device cpu runs on the CPU), or on several with
--mesh: one process per device, run by torchrun or with --multihost.

Same flags, defaults and TSV schema (``idx label predict correct gap radius
time``, one row appended per identity) as the JAX CLI, plus --model-name
(the generator, as cfr-generate-data-torch -m names it: its weights, its
synthesis, its latents ``w.npy`` or, for PGGAN, ``z.npy`` in --data-dir,
and its W or Z boundaries) and --device:
  * anisotropic sigma = --sigma * red_ellipse_diag^{-1};
  * radius = sigma.min() * gap;
  * --skip/--max striding (with the reference's (i+1) arithmetic), then the
    --chunks/--num-chunk split; --resume skips identities already written.
With --mesh every rank runs the same identity loop: the MC batch is split
over the mc ranks, the gallery over the --mesh-id ranks, and rank 0 alone
writes the TSV; the TSV does not depend on the number of ranks.
"""

from __future__ import annotations

import argparse
import datetime
import os
import os.path as osp
from time import time

import numpy as np
import torch
import torch.distributed as dist

from ..constants import FRS_METHODS
from ..models.pipeline import FacePipeline
from ..ops import geometry as G
from ..smoothing.certificate import L2Certificate
from ..smoothing.smooth import Smooth, identity_generator
from ..utils import weights as W
from . import opts

TSV_HEADER = "idx\tlabel\tpredict\tcorrect\tgap\tradius\ttime"

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Certify face recognition examples (PyTorch/CUDA)")
    parser.add_argument("--face-recog-model", required=True,
                        choices=FRS_METHODS, type=str,
                        help="type of model to load for face recognition")
    parser.add_argument("--outfile", required=True, type=str,
                        help="output csv file")
    parser.add_argument("--sigma", type=float, required=True,
                        help="noise hyperparameter")
    parser.add_argument("--anisotropic-sigma", action="store_true",
                        default=False,
                        help="Whether to use Anisotropic Sigma")
    parser.add_argument("--skip", type=int, default=1,
                        help="skip examples in the dataset")
    parser.add_argument("--max", type=int, default=-1,
                        help="stop after a certain number of examples")
    parser.add_argument("--batch-sz", type=int, default=100,
                        help="certification batch size")
    parser.add_argument("--N0", type=int, default=100)
    parser.add_argument("--N", type=int, default=100000,
                        help="number of samples to use")
    parser.add_argument("--alpha", type=float, default=0.001,
                        help="failure probability")
    parser.add_argument("--load-n-embs", type=int, default=1_000_000,
                        help="num of embs. Default is all of them (1M)")
    parser.add_argument("--chunks", type=int, default=1,
                        help="job-array sharding of the identity axis: split "
                             "the post---skip/--max identity list into this "
                             "many contiguous chunks")
    parser.add_argument("--num-chunk", type=int, default=0,
                        help="which chunk this job certifies (0-based)")
    opts.add_model_name(parser)
    parser.add_argument("--gen-weights", type=str, default="random")
    parser.add_argument("--frm-weights", type=str, default="random")
    parser.add_argument("--data-dir", type=str,
                        default=os.environ.get("CFR_DATA_DIR",
                                               "data/stylegan_ffhq_1M"))
    parser.add_argument("--embs-file", type=str, default=None,
                        help="Gallery embeddings (.npz with 'embs', or .pth)")
    parser.add_argument("--boundaries-dir", type=str, default=None)
    parser.add_argument("--resolution", type=int, default=1024)
    parser.add_argument("--synthesis-resolution", type=int, default=None,
                        help="Truncate synthesis at this resolution (uses "
                             "the matching early layers + ToRGB head of the "
                             "--resolution weights). The FRM consumes 112^2 "
                             "either way. Gallery embeddings must be "
                             "computed at the same synthesis resolution; the "
                             "default cache name is then "
                             "embs_<model>_sr<res>.npz (cfr-attack-torch with "
                             "the same --synthesis-resolution produces it).")
    parser.add_argument("--cascade", action="store_true", default=False,
                        help="Decision-safe reduced-resolution mode: run the "
                             "MC loop at --synthesis-resolution, and any "
                             "identity whose fast-path prediction matches its "
                             "label is RE-CERTIFIED at the native "
                             "--resolution before its row is written: every "
                             "emitted correct/certified row is native-grade "
                             "by construction, while rejections and "
                             "abstentions keep the fast path. The residual "
                             "deviation is conservative (a fast-path "
                             "rejection the native model would certify "
                             "loses that certification, never invents one).")
    parser.add_argument("--native-embs-file", type=str, default=None,
                        help="With --cascade: native-resolution gallery "
                             "embeddings (defaults to embs_<model>.npz in "
                             "--data-dir; --embs-file names the reduced-"
                             "resolution gallery)")
    parser.add_argument("--adaptive", type=str, default="off",
                        choices=["off", "guaranteed", "sequential"],
                        help="Early-stopping certification "
                             "(smoothing/smooth.certify_adaptive). "
                             "'guaranteed': deterministic futility bounds: "
                             "emitted certify/abstain decisions are provably "
                             "identical to the fixed-N run for the same seed "
                             "(certified radii conservative within "
                             "--adaptive-slack). 'sequential': "
                             "alpha-spending checkpoints: much earlier "
                             "stops for clear-cut identities, decisions "
                             "aligned with fixed-N only statistically "
                             "(coverage still holds at --alpha). Off by "
                             "default: the reference estimator is fixed-N.")
    parser.add_argument("--adaptive-chunk-batches", type=int, default=8,
                        help="Batches between early-stop checks (each check "
                             "is one read of the device by the host)")
    parser.add_argument("--adaptive-engine", type=str, default="host",
                        choices=["host", "device"],
                        help="'host': reads the running success count at "
                             "each check and evaluates the stopping rules on "
                             "the host. 'device': counts, success count and "
                             "status stay on the device, which compares the "
                             "count with precomputed Clopper-Pearson integer "
                             "thresholds (smoothing/adaptive_device.py); the "
                             "host reads one status per check. Identical "
                             "results except guaranteed-mode "
                             "--adaptive-gap-target (documented there)")
    parser.add_argument("--adaptive-group", type=int, default=1,
                        help="Device engine only: certify this many "
                             "identities per call, each with its own early "
                             "exit, with one read of their results (results "
                             "per identity are identical to group 1; the TSV "
                             "time is the group's split evenly). "
                             "Incompatible with --cascade.")
    parser.add_argument("--adaptive-slack", type=float, default=0.1,
                        help="Stop a settled certification once its "
                             "(conservative) gap is within this fraction of "
                             "the best still-achievable gap")
    parser.add_argument("--adaptive-gap-target", type=float, default=None,
                        help="Deployment question 'certified at radius >= "
                             "sigma_min * TARGET?': stop as soon as that bit "
                             "is settled. In guaranteed mode the at-target "
                             "answer matches the fixed-N run per seed; this "
                             "is where guaranteed mode's large certify-side "
                             "savings come from (without it, full-radius "
                             "certifications must run to ~N by construction)")
    parser.add_argument("--dtype", type=str, default="fp32",
                        choices=["fp32", "bf16"])
    parser.add_argument("--mesh", action="store_true", default=False,
                        help="Split the MC batch over the ranks of a process "
                             "group, one process per device (torchrun, or "
                             "--multihost); one process alone is a group of "
                             "one")
    parser.add_argument("--mesh-id", type=int, default=1,
                        help="With --mesh: id-axis size; shards the gallery "
                             "over this many devices (1M-identity regime)")
    parser.add_argument("--multihost", action="store_true", default=False,
                        help="Join a torch.distributed group from "
                             "--coordinator-address, --num-processes and "
                             "--process-id (one process per device), or "
                             "from torchrun's environment when they are not "
                             "given. Replaces the reference's SLURM job "
                             "arrays (README.md:17-18) with one group over "
                             "every host's devices.")
    parser.add_argument("--coordinator-address", type=str, default=None,
                        help="host:port of process 0 (only needed without "
                             "torchrun)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--resume", action="store_true", default=False,
                        help="Append to an existing outfile, skipping "
                             "already-certified identities")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="device to run on (cuda needs a CUDA GPU)")
    return parser


def load_gallery(args, synthesis_resolution=None,
                 embs_file=None) -> np.ndarray:
    """The gallery embeddings; reduced-resolution ones have their own
    default name (cli/main_attack.get_embs writes it)."""
    sr = f"_sr{synthesis_resolution}" if synthesis_resolution else ""
    path = embs_file or osp.join(
        args.data_dir, f"embs_{args.face_recog_model}{sr}.npz")
    embs = W.load_embeddings(path, mmap=True)[: args.load_n_embs]
    return np.asarray(embs, np.float32)


def identity_order(num_classes: int, skip: int, max_: int, chunks: int,
                   num_chunk: int) -> list:
    """Identities to certify: --skip/--max striding (the reference's
    arithmetic: the --max break is only reached by indices that pass
    --skip), then the contiguous --chunks split."""
    strided = []
    for i in range(num_classes):
        if (i + 1) % skip != 0:
            continue
        if (i + 1) == max_:
            break
        strided.append(i)
    if not 0 <= num_chunk < chunks:
        raise SystemExit("--num-chunk must be in [0, --chunks)")
    if chunks > 1:
        strided = [int(v) for v in np.array_split(
            np.asarray(strided, np.int64), chunks)[num_chunk]]
    return strided


def resumed_ids(outfile: str, num_classes: int, device) -> set:
    """Identities already in ``outfile``. In a group of several ranks only
    rank 0 writes the TSV, and another rank may not see it (no shared
    file system): rank 0's set is broadcast as a bitmask, so that every
    rank runs the same sequence of collective certifications."""
    done = set()
    if osp.isfile(outfile):
        with open(outfile) as f:
            for line in f:
                cols = line.split("\t")
                if cols and cols[0].isdigit():
                    done.add(int(cols[0]))
    if dist.is_initialized() and dist.get_world_size() > 1:
        mask = torch.zeros((num_classes,), dtype=torch.uint8, device=device)
        if dist.get_rank() == 0:
            ids = [i for i in done if i < num_classes]
            mask[torch.as_tensor(ids, dtype=torch.int64, device=device)] = 1
        dist.broadcast(mask, src=0)
        done = set(torch.nonzero(mask)[:, 0].tolist())
    return done


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    opts.refuse_stylegan_only(args, (("synthesis_resolution",
                                      "--synthesis-resolution"),
                                     ("cascade", "--cascade")))
    device = args.device
    distributed = args.mesh or args.multihost
    mesh = None
    if distributed:
        from ..parallel.mesh import init_distributed, make_mesh

        coord = (args.coordinator_address, args.num_processes,
                 args.process_id) if args.multihost else (None,) * 3
        device = init_distributed(*coord, device=device)
    try:
        if args.mesh:
            mesh = make_mesh(args.mesh_id)
        if distributed:
            print(f"distributed: rank {dist.get_rank()} of "
                  f"{dist.get_world_size()}, backend {dist.get_backend()}, "
                  f"mesh mc {mesh.n_mc if mesh else 1} x id "
                  f"{mesh.n_id if mesh else 1}", flush=True)
        _certify(args, device, mesh)
    finally:
        if distributed:
            dist.destroy_process_group()


def _certify(args, device, mesh) -> None:
    # every rank runs the whole loop (the certifications are collective
    # over the group); rank 0 alone writes the TSV
    is_writer = not dist.is_initialized() or dist.get_rank() == 0
    region = G.get_all_matrices(boundaries_dir=args.boundaries_dir,
                                model_name=args.model_name)
    dirs = region.dirs.T                       # [k, 512] rows
    num_dirs = dirs.shape[0]

    dataset = np.load(opts.latents_file(args.data_dir, args.model_name),
                      mmap_mode="r")
    dataset = dataset[: args.load_n_embs]
    gallery = load_gallery(args, args.synthesis_resolution, args.embs_file)
    assert len(gallery) == len(dataset), \
        f"{len(gallery)} embeddings vs {len(dataset)} latents"
    num_classes = dataset.shape[0]
    print(f"Found {num_classes} classes")
    print(f"Found {num_dirs} directions")

    if args.cascade and not (args.synthesis_resolution
                             and args.synthesis_resolution < args.resolution):
        raise SystemExit("--cascade requires --synthesis-resolution below "
                         "--resolution (it is the fast path being verified)")
    if args.adaptive != "off" and args.adaptive_group > 1:
        if args.adaptive_engine != "device":
            raise SystemExit("--adaptive-group > 1 requires "
                             "--adaptive-engine device")
        if args.cascade:
            raise SystemExit("--adaptive-group is incompatible with "
                             "--cascade")

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    gen_params = W.load_generator_params(args.gen_weights, args.model_name,
                                         resolution=args.resolution,
                                         device=device)
    frm_params = W.load_frm_params(args.frm_weights, args.face_recog_model,
                                   device=device)

    if args.anisotropic_sigma:
        sigma = args.sigma * np.asarray(region.red_ellipse_diag_inv)
    else:
        sigma = np.full((num_dirs,), args.sigma, np.float32)

    def build_smoothed(gallery_arr, resolution):
        """FacePipeline + Smooth at a synthesis resolution: built once for
        the main path, twice under --cascade (fast reduced-resolution +
        native verifier). With a mesh the pipeline holds this rank's block
        of gallery rows."""
        offset = 0
        if mesh is not None:
            from ..parallel.gallery import shard_rows

            offset, stop = shard_rows(len(gallery_arr), mesh.n_id, mesh.id)
            gallery_arr = gallery_arr[offset:stop]
        pipe = FacePipeline(gen_params, frm_params,
                            dirs=torch.as_tensor(dirs),
                            frs_method=args.face_recog_model,
                            resolution=resolution, dtype=dtype,
                            gallery=torch.as_tensor(gallery_arr),
                            device=device, generator=args.model_name)
        predict_fn, params = pipe.predict_fn_with_params(mesh, offset)
        return Smooth(predict_fn, num_classes, sigma, L2Certificate(),
                      noise_dim=num_dirs, batch_size=args.batch_sz,
                      params=params, device=device, mesh=mesh)

    smoothed = build_smoothed(gallery,
                              args.synthesis_resolution or args.resolution)
    smoothed_native = None
    if args.cascade:
        native_gallery = load_gallery(args, None, args.native_embs_file)
        assert len(native_gallery) == num_classes, \
            f"native gallery {len(native_gallery)} vs {num_classes} latents"
        smoothed_native = build_smoothed(native_gallery, args.resolution)

    os.makedirs(osp.dirname(osp.abspath(args.outfile)), exist_ok=True)
    done = set()
    if args.resume:
        done = resumed_ids(args.outfile, num_classes, device)
        print(f"Resuming: {len(done)} identities already certified")
    elif is_writer:
        with open(args.outfile, "w+") as f:
            print(TSV_HEADER, file=f, flush=True)

    x = np.zeros((num_dirs,), np.float32)
    radius_scale = float(np.min(sigma))
    adaptive_kw = dict(mode=args.adaptive,
                       chunk_batches=args.adaptive_chunk_batches,
                       slack=args.adaptive_slack,
                       gap_target=args.adaptive_gap_target)

    def report_samples(i, n_used):
        print(f"adaptive[{args.adaptive}] id {i}: "
              f"{n_used}/{args.N0 + args.N} samples")

    def write_row(i, prediction, gap, seconds):
        if not is_writer:
            return
        elapsed = str(datetime.timedelta(seconds=seconds))
        with open(args.outfile, "a") as f:
            print(f"{i}\t{i}\t{prediction}\t{int(prediction == i)}\t"
                  f"{gap:.3}\t{radius_scale * gap:.3}\t{elapsed}", file=f,
                  flush=True)

    eligible = [i for i in identity_order(num_classes, args.skip, args.max,
                                          args.chunks, args.num_chunk)
                if i not in done]
    if args.adaptive != "off" and args.adaptive_group > 1:
        group = args.adaptive_group
        for g0 in range(0, len(eligible), group):
            ids = eligible[g0:g0 + group]
            before = time()
            results = smoothed.certify_adaptive_many(
                [dataset[i] for i in ids], [x] * len(ids), ids, args.N0,
                args.N, args.alpha,
                [identity_generator(args.seed, i, device) for i in ids],
                pad_to=group, **adaptive_kw)
            # the TSV time column reports per-identity wall time; inside a
            # group that is the group's time split evenly
            per_id = (time() - before) / len(ids)
            for i, (prediction, gap, n_used) in zip(ids, results):
                report_samples(i, n_used)
                write_row(i, prediction, gap, per_id)
        return

    for i in eligible:
        z = dataset[i]
        before = time()
        # Cascade generator discipline: the fast pass draws from a DERIVED
        # generator, so its outcome (the selection event) is independent of
        # the native pass's noise; the native pass draws from exactly the
        # generator a plain native run would use, so every row the cascade
        # emits after a native pass equals that run's row.
        gen_fast = identity_generator(
            args.seed, i, device,
            stream=None if smoothed_native is None else 1)

        def run_certify(sm, gen):
            if args.adaptive == "off":
                return sm.certify(z, x, i, args.N0, args.N, args.alpha, gen)
            prediction, gap, n_used = sm.certify_adaptive(
                z, x, i, args.N0, args.N, args.alpha, gen,
                engine=args.adaptive_engine, **adaptive_kw)
            report_samples(i, n_used)
            return prediction, gap

        prediction, gap = run_certify(smoothed, gen_fast)
        if smoothed_native is not None and prediction == i:
            prediction, gap = run_certify(
                smoothed_native, identity_generator(args.seed, i, device))
        write_row(i, prediction, gap, time() - before)


if __name__ == "__main__":
    main()
