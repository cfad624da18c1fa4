"""Stage-by-stage profile of a certification batch at a (batch, gallery)
point (port of certifyingfacerecognition_tpu/tools/gallery_bench.py).

The stages are cumulative, each one the previous plus one step of the
pipeline (make_stages):

  * ``pre``: the synthesis blocks before the chain boundary
    (stylegan.synthesis_prefix, as synthesis_apply runs them), or up to
    ``--pre-res``;
  * ``pret``: ``pre`` plus the transpose into the tail's [H, W, C, B]
    layout (models/stylegan._synthesis_tail_bc);
  * ``synth``: the whole synthesis, through tail_chain_bc when
    CFR_TAIL=bc (bf16), and the [0, 1] postprocess;
  * ``resize``: plus the bilinear resize and normalisation for the FRM;
  * ``embed``: the whole embedding (synthesis + ArcFace iresnet-50);
  * ``matmul``: plus the [B, N] squared distances, f32 (TF32 off);
  * ``matmul_high``: the same product with TF32 allowed, for candidate
    selection only (the counterpart of the JAX package's
    Precision.HIGH pass; the exact re-rank still decides);
  * ``topk``: ``matmul`` plus the 8 nearest candidates;
  * ``refine``: the whole classifier head, argmin_dist_refined.

Each stage is timed with ``utils/profiling.measure`` over ``--injit``
launches, each launch's input depending on the previous launch's output
(one element carried as a scalar), and prints one JSON line: its ms per
batch, the delta to the previous stage and samples/s. Weights: StyleGAN
random:0, ArcFace iresnet-50 He-scaled (random:0 FRM weights give NaN
embeddings); gallery and latents are drawn on the device.

    CFR_TAIL=bc python -m \\
        certifyingfacerecognition_torch.tools.gallery_bench \\
        --gallery 100000 --batch 128 --stages embed,matmul,topk,refine
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import Callable, Dict

import numpy as np
import torch

from ..utils.profiling import measure

STAGES = ("pre", "pret", "synth", "resize", "embed", "matmul", "matmul_high",
          "topk", "refine")


@contextlib.contextmanager
def _tf32(allow: bool):
    """cuBLAS matmuls with TF32 allowed or not; the flag is restored."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def make_stages(gen_params: Dict, frm_params: Dict, gallery: torch.Tensor,
                resolution: int, dtype=torch.bfloat16, device="cuda",
                pre_res: int = 0) -> Dict[str, Callable]:
    """{stage: fn(w [B, 512]) -> that stage's output} over the given
    weights and gallery [N, 512] f32 (see the module docstring); the
    functions run under torch.inference_mode."""
    from ..constants import INP_RESOLS, MEAN, STD
    from ..models import stylegan
    from ..models.pipeline import make_lat2embs
    from ..ops import distances as D
    from ..ops.resize import transform_for_frs, transform_for_frs_cb
    from ..utils.device import resolve_device, tree_map

    dev = resolve_device(device)
    gen = tree_map(lambda t: torch.as_tensor(t, device=dev), gen_params)
    frm = tree_map(lambda t: torch.as_tensor(t, device=dev), frm_params)
    g = torch.as_tensor(gallery, dtype=torch.float32, device=dev)
    embed = make_lat2embs("insightface", resolution, dtype=dtype)
    use_cb = stylegan.cb_out_active(resolution, dtype)
    img_size = INP_RESOLS["insightface"]
    # block bi outputs 2^(bi+1): --pre-res stops before block log2(pre_res)
    stop = int(np.log2(pre_res)) if pre_res else None

    def pre(w):
        """synthesis_apply's plain-ops prefix: the NCHW output of the last
        block before the chain boundary (or --pre-res)."""
        wp = stylegan.truncation_apply(gen, w, resolution=resolution)
        return stylegan.synthesis_prefix(gen, wp, resolution=resolution,
                                         dtype=dtype, stop=stop)

    def pret(w):
        return pre(w).permute(2, 3, 1, 0).contiguous()

    def synth(w):
        return stylegan.synthesize_from_w(gen, w, resolution=resolution,
                                          dtype=dtype, cb_out=use_cb)

    def resize(w):
        img = synth(w)
        if use_cb:
            return transform_for_frs_cb(img, img_size, MEAN, STD)
        return transform_for_frs(img, img_size, MEAN, STD)

    def embed_f32(w):
        return embed(gen, frm, w).float()

    def matmul(w):
        e = embed_f32(w)
        with _tf32(False):
            return D.sq_euclidean_matmul(e, g)

    def matmul_high(w):
        e = embed_f32(w)
        with _tf32(True):
            return D.sq_euclidean_matmul(e, g)

    def topk(w):
        d2 = matmul(w)
        return torch.topk(d2, min(8, d2.shape[1]), dim=1,
                          largest=False).indices

    def refine(w):
        return D.argmin_dist_refined(embed_f32(w), g, "insightface")

    fns = {"pre": pre, "pret": pret, "synth": synth, "resize": resize,
           "embed": embed_f32, "matmul": matmul, "matmul_high": matmul_high,
           "topk": topk, "refine": refine}

    def forward_only(fn):
        def run(w):
            with torch.inference_mode():
                return fn(w)
        return run

    return {k: forward_only(v) for k, v in fns.items()}


def bench_inputs(gallery: int, batch: int, device="cuda"):
    """(gallery [N, 512], latents [B, 512]) f32, drawn on the device from
    seeds 0 and 1."""
    gen = torch.Generator(device=device)
    g = torch.randn((gallery, 512), generator=gen.manual_seed(0),
                    device=device)
    w0 = torch.randn((batch, 512), generator=gen.manual_seed(1),
                     device=device)
    return g, w0


def bench_weights(resolution: int, device="cuda"):
    """(StyleGAN random:0, He-scaled ArcFace iresnet-50) parameter trees."""
    from ..models import iresnet
    from ..utils import weights as W

    gen = W.load_generator_params("random:0", resolution=resolution,
                                  device=device)
    frm = iresnet.convert_torch_state_dict(
        iresnet.random_torch_style_state_dict("iresnet50", seed=0,
                                              realistic=True), device=device)
    return gen, frm


def time_stage(fn: Callable, w0: torch.Tensor, injit: int, reps: int
               ) -> float:
    """ms per batch of ``fn``: ``injit`` launches per timed run, the input
    of each w0 + c, where c is 0 times one element of the previous
    launch's output (so every launch waits for the previous one)."""
    n = max(injit, 1)

    def rep(w0):
        c = torch.zeros((), device=w0.device)
        for _ in range(n):
            out = fn(w0 + c)
            c = c + out.reshape(-1)[0].float() * 0
        return c

    return measure(rep, w0, reps=reps) * 1e3 / n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--gallery", type=int, default=100000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--injit", type=int, default=4)
    p.add_argument("--stages", type=str, default="all")
    p.add_argument("--pre-res", type=int, default=0,
                   help="cut the pre/pret stages after the block with this "
                        "output resolution (default: the chain boundary, "
                        "or the full synthesis when the chain is off)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda needs a CUDA GPU")
    args = p.parse_args(argv)

    from ..utils.device import device_name, resolve_device

    device = resolve_device(args.device)
    gallery, w0 = bench_inputs(args.gallery, args.batch, device)
    stages = make_stages(*bench_weights(args.resolution, device), gallery,
                         args.resolution, torch.bfloat16, device,
                         pre_res=args.pre_res)
    names = list(STAGES) if args.stages == "all" else args.stages.split(",")
    kind = device_name(device)
    prev = 0.0
    for name in names:
        ms = time_stage(stages[name], w0, args.injit, args.reps)
        print(json.dumps({"stage": name, "ms_per_batch": ms,
                          "delta_ms": ms - prev,
                          "samples_per_sec": args.batch / (ms / 1e3),
                          "device": kind}), flush=True)
        prev = ms


if __name__ == "__main__":
    main()
