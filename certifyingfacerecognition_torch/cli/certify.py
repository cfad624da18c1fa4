"""Certification CLI (port of certifyingfacerecognition_tpu/cli/certify.py):
randomized-smoothing certification of identities with a fixed Monte-Carlo
budget, on one CUDA device by default (--device cpu runs on the CPU).

Same flags, defaults and TSV schema (``idx label predict correct gap radius
time``, one row appended per identity) as the JAX CLI:
  * anisotropic sigma = --sigma * red_ellipse_diag^{-1};
  * radius = sigma.min() * gap;
  * --skip/--max striding (with the reference's (i+1) arithmetic), then the
    --chunks/--num-chunk split; --resume skips identities already written.
Flags of features this port does not have yet exit with a message that
names the ROADMAP item porting them.
"""

from __future__ import annotations

import argparse
import datetime
import os
import os.path as osp
from time import time

import numpy as np
import torch

from ..constants import FRS_METHODS
from ..models.pipeline import FacePipeline
from ..ops import geometry as G
from ..smoothing.certificate import L2Certificate
from ..smoothing.smooth import Smooth, identity_generator
from ..utils import weights as W

TSV_HEADER = "idx\tlabel\tpredict\tcorrect\tgap\tradius\ttime"

# flag -> (default, ROADMAP item of ROADMAP.md "Open items" 1 porting it)
_NOT_PORTED = {
    "synthesis_resolution": (None, "11 (reduced resolution and cascade)"),
    "cascade": (False, "11 (reduced resolution and cascade)"),
    "native_embs_file": (None, "11 (reduced resolution and cascade)"),
    "adaptive": ("off", "8 (adaptive certification)"),
    "adaptive_chunk_batches": (8, "8 (adaptive certification)"),
    "adaptive_engine": ("host", "8 (adaptive certification)"),
    "adaptive_group": (1, "8 (adaptive certification)"),
    "adaptive_slack": (0.1, "8 (adaptive certification)"),
    "adaptive_gap_target": (None, "8 (adaptive certification)"),
    "mesh": (False, "9 (parallel runs)"),
    "mesh_id": (1, "9 (parallel runs)"),
    "multihost": (False, "9 (parallel runs)"),
    "coordinator_address": (None, "9 (parallel runs)"),
    "num_processes": (None, "9 (parallel runs)"),
    "process_id": (None, "9 (parallel runs)"),
}


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
                        help="not ported yet")
    parser.add_argument("--cascade", action="store_true", default=False,
                        help="not ported yet")
    parser.add_argument("--native-embs-file", type=str, default=None,
                        help="not ported yet")
    parser.add_argument("--adaptive", type=str, default="off",
                        choices=["off", "guaranteed", "sequential"],
                        help="not ported yet (only 'off')")
    parser.add_argument("--adaptive-chunk-batches", type=int, default=8,
                        help="not ported yet")
    parser.add_argument("--adaptive-engine", type=str, default="host",
                        choices=["host", "device"], help="not ported yet")
    parser.add_argument("--adaptive-group", type=int, default=1,
                        help="not ported yet")
    parser.add_argument("--adaptive-slack", type=float, default=0.1,
                        help="not ported yet")
    parser.add_argument("--adaptive-gap-target", type=float, default=None,
                        help="not ported yet")
    parser.add_argument("--dtype", type=str, default="fp32",
                        choices=["fp32", "bf16"])
    parser.add_argument("--mesh", action="store_true", default=False,
                        help="not ported yet")
    parser.add_argument("--mesh-id", type=int, default=1,
                        help="not ported yet")
    parser.add_argument("--multihost", action="store_true", default=False,
                        help="not ported yet")
    parser.add_argument("--coordinator-address", type=str, default=None,
                        help="not ported yet")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="not ported yet")
    parser.add_argument("--process-id", type=int, default=None,
                        help="not ported yet")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="Append to an existing outfile, skipping "
                             "already-certified identities")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="device to run on (cuda needs a CUDA GPU)")
    return parser


def _reject_unported(args) -> None:
    for name, (default, item) in _NOT_PORTED.items():
        if getattr(args, name) != default:
            raise SystemExit(f"--{name.replace('_', '-')} is not ported to "
                             f"the PyTorch package yet: ROADMAP.md 'Open "
                             f"items' 1, item {item}")


def load_gallery(args, embs_file=None) -> np.ndarray:
    path = embs_file or osp.join(args.data_dir,
                                 f"embs_{args.face_recog_model}.npz")
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


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    _reject_unported(args)
    device = args.device

    region = G.get_all_matrices(boundaries_dir=args.boundaries_dir)
    dirs = region.dirs.T                       # [k, 512] rows
    num_dirs = dirs.shape[0]

    dataset = np.load(osp.join(args.data_dir, "w.npy"), mmap_mode="r")
    dataset = dataset[: args.load_n_embs]
    gallery = load_gallery(args, args.embs_file)
    assert len(gallery) == len(dataset), \
        f"{len(gallery)} embeddings vs {len(dataset)} latents"
    num_classes = dataset.shape[0]
    print(f"Found {num_classes} classes")
    print(f"Found {num_dirs} directions")

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    gen_params = W.load_generator_params(args.gen_weights,
                                         resolution=args.resolution,
                                         device=device)
    frm_params = W.load_frm_params(args.frm_weights, args.face_recog_model,
                                   device=device)

    if args.anisotropic_sigma:
        sigma = args.sigma * np.asarray(region.red_ellipse_diag_inv)
    else:
        sigma = np.full((num_dirs,), args.sigma, np.float32)

    pipe = FacePipeline(gen_params, frm_params, dirs=torch.as_tensor(dirs),
                        frs_method=args.face_recog_model,
                        resolution=args.resolution, dtype=dtype,
                        gallery=torch.as_tensor(gallery), device=device)
    predict_fn, params = pipe.predict_fn_with_params()
    smoothed = Smooth(predict_fn, num_classes, sigma, L2Certificate(),
                      noise_dim=num_dirs, batch_size=args.batch_sz,
                      params=params, device=device)

    os.makedirs(osp.dirname(osp.abspath(args.outfile)), exist_ok=True)
    done = set()
    if args.resume:
        if osp.isfile(args.outfile):
            with open(args.outfile) as f:
                for line in f:
                    cols = line.split("\t")
                    if cols and cols[0].isdigit():
                        done.add(int(cols[0]))
        print(f"Resuming: {len(done)} identities already certified")
    else:
        with open(args.outfile, "w+") as f:
            print(TSV_HEADER, file=f, flush=True)

    x = np.zeros((num_dirs,), np.float32)
    for i in identity_order(num_classes, args.skip, args.max, args.chunks,
                            args.num_chunk):
        if i in done:
            continue
        before = time()
        prediction, gap = smoothed.certify(
            dataset[i], x, i, args.N0, args.N, args.alpha,
            identity_generator(args.seed, i, pipe.device))
        elapsed = str(datetime.timedelta(seconds=time() - before))
        correct = int(prediction == i)
        radius = float(np.min(sigma)) * gap
        with open(args.outfile, "a") as f:
            print(f"{i}\t{i}\t{prediction}\t{correct}\t{gap:.3}\t"
                  f"{radius:.3}\t{elapsed}", file=f, flush=True)


if __name__ == "__main__":
    main()
