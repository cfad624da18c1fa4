"""Attack CLI (port of certifyingfacerecognition_tpu/cli/main_attack.py):
gallery embeddings computed once and cached, per-chunk attacks, and
the --eval-files aggregation, on one CUDA device by default (--device cpu
runs on the CPU).

Same flags, defaults and artifact layout (exp_results/<out>/{results,
logs,figs}) as the JAX CLI: PGD (--attack-type manual, the reference's
default), the AutoAttack family (apgd-ce, apgd-dlr, apgd-t, fab-t, square
and the autoattack, autoattack-rand and autoattack-plus presets) and
--run-checks, for every --face-recog-method; --profile-dir traces the
chunks with torch.profiler (utils/profiling.trace: the trace, and each
span's calls, host and self ms beside it).

--mesh or --multihost: one process per device, run by torchrun or with
--multihost (parallel/mesh.init_distributed; NCCL on cuda, gloo on cpu),
and the same decomposition under either flag. Each rank
attacks whole batches of --batch-size identities, batch j of a chunk on
rank j % world, so --batch-size is the per-device batch (the JAX CLI
splits the rows of one global batch over its devices instead). Every
batch keeps its own seed and shape, so the results do not depend on the
number of ranks. Rank 0 gathers the batches, re-verifies, writes every
artifact and aggregates; the other ranks write nothing.
"""

from __future__ import annotations

import contextlib
import os.path as osp
from time import time

import numpy as np
import torch
import torch.distributed as dist

from ..constants import DEFAULT_MODEL, EMB_SIZE
from ..eval.chunk_runner import (_make_attack_step, eval_chunk, eval_files,
                                 make_dists_fn, make_predict_fn)
from ..models.pipeline import FacePipeline
from ..ops import geometry as G
from ..utils import profiling
from ..utils import weights as W
from . import opts


def get_latent_codes(data_dir: str, n: int = None,
                     model_name: str = DEFAULT_MODEL) -> np.ndarray:
    """The latent array of generator ``model_name`` (w.npy; z.npy for
    PGGAN)."""
    lats = np.load(opts.latents_file(data_dir, model_name)).astype(np.float32)
    return lats[:n] if n else lats


def get_embs(args, pipeline: FacePipeline, lat_codes: np.ndarray,
             cache: bool = True) -> np.ndarray:
    """Load cached gallery embeddings, or compute them and (``cache``)
    cache them. Reduced-resolution embeddings are not interchangeable
    with native ones, so their default cache name says the synthesis
    resolution (an explicit --embs-file is the user's responsibility)."""
    log = args.LOGGER
    sr = (f"_sr{args.synthesis_resolution}"
          if args.synthesis_resolution else "")
    embs_file = args.embs_file or osp.join(
        args.data_dir, f"embs_{args.face_recog_method}{sr}.npz")
    if args.load_embs:
        log.info(f"Loading embeddings from {embs_file}")
        embs = W.load_embeddings(embs_file)[: args.load_n_embs]
    else:
        log.info(f"Computing embeddings for {len(lat_codes)} identities")
        t0 = time()
        embs = pipeline.lat2embs(lat_codes, chunk=max(args.batch_size, 32)
                                 ).float().cpu().numpy()
        log.info(f"Embeddings done in {time() - t0:3.1f}s")
        if cache:
            log.info(f"Caching embeddings to {embs_file}")
            np.savez(embs_file, embs=embs)
    assert embs.ndim == 2 and embs.shape[1] == EMB_SIZE, embs.shape
    assert len(embs) == len(lat_codes), \
        f"{len(embs)} embeddings vs {len(lat_codes)} latents"
    return np.asarray(embs, np.float32)


def main(argv=None) -> None:
    args = opts.build_parser().parse_args(argv)
    opts.refuse_stylegan_only(args, (("synthesis_resolution",
                                      "--synthesis-resolution"),))
    distributed = args.mesh or args.multihost
    if distributed:
        from ..parallel.mesh import init_distributed

        coord = (args.coordinator_address, args.num_processes,
                 args.process_id) if args.multihost else (None,) * 3
        args.device = init_distributed(*coord, device=args.device)
    try:
        is_writer = not distributed or dist.get_rank() == 0
        args = opts.finalize_args(args, writer=is_writer)
        if distributed:
            args.LOGGER.info(f"distributed: rank {dist.get_rank()} of "
                             f"{dist.get_world_size()}, backend "
                             f"{dist.get_backend()}")
        _attack(args, is_writer)
        if distributed:
            dist.barrier()
    finally:
        if distributed:
            dist.destroy_process_group()


def _attack(args, is_writer: bool) -> None:
    log = args.LOGGER
    t0 = time()

    if args.eval_files:
        if is_writer:
            eval_files(args)
        log.info(f"Total time: {time() - t0:3.1f}s")
        return

    device = args.device
    region = G.get_all_matrices(args.attrs2drop,
                                scale_factor=args.scale_factor,
                                boundaries_dir=args.boundaries_dir,
                                device=device,
                                model_name=args.model_name)
    lat_codes = get_latent_codes(args.data_dir, args.load_n_embs,
                                 args.model_name)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    gen_params = W.load_generator_params(args.gen_weights, args.model_name,
                                         resolution=args.resolution,
                                         device=device)
    frm_params = W.load_frm_params(args.frm_weights, args.face_recog_method,
                                   device=device)
    syn_res = args.synthesis_resolution or args.resolution
    pipeline = FacePipeline(gen_params, frm_params, dirs=region.dirs.t(),
                            frs_method=args.face_recog_method,
                            resolution=syn_res, dtype=dtype, device=device,
                            generator=args.model_name)
    # a plain tensor, not an inference-mode one: the attack differentiates
    # against it
    gallery = torch.as_tensor(get_embs(args, pipeline, lat_codes, is_writer),
                              device=pipeline.device)
    params = {"gen": pipeline.gen_params, "frm": pipeline.frm_params,
              "gallery": gallery}
    # Without --num-chunk every chunk runs in turn, then the aggregation.
    chunks_to_run = ([args.num_chunk] if args.num_chunk is not None
                     else range(args.chunks))
    dists_fn = make_dists_fn(args.face_recog_method, syn_res, dtype,
                             generator=args.model_name)
    attack_step = _make_attack_step(dists_fn, region, args)
    predict_fn = make_predict_fn(args.face_recog_method, syn_res, dtype,
                                 generator=args.model_name)
    # in a process group rank 0 alone traces
    tracing = args.profile_dir and is_writer
    with (profiling.trace(args.profile_dir) if tracing
          else contextlib.nullcontext()):
        for num_chunk in chunks_to_run:
            log_file = eval_chunk(params, lat_codes, num_chunk, args,
                                  region=region, dists_fn=dists_fn,
                                  attack_step=attack_step,
                                  predict_fn=predict_fn)
            if log_file is not None:
                log.info(f"Chunk log at {log_file}")
        if args.num_chunk is None and is_writer:
            eval_files(args)
    if tracing:
        log.info(f"Trace written under {args.profile_dir}")
    log.info(f"Total time: {time() - t0:3.1f}s")


if __name__ == "__main__":
    main()
