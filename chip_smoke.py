"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs straight through and raises (exit code != 0) on any failure:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: compiles the hand-written kernels from csrc/ (nvcc, sm_90a);
3. each kernel of the bf16 synthesis tail against its plain PyTorch version
   at the 1024^2 tail's shapes (B = 8), bf16 and f32, with and without the
   input affine, and the whole kernel chain against a plain chain;
4. each kernel's time at B = 128 (CUDA events, median of 5) beside its
   plain version's time, its roofline bound and the time of cuDNN's
   convolution of the same layer (the library yardstick);
5. the main path: ``cfr-certify`` (cli.certify.main) at 1024^2 in bf16 with
   CFR_TAIL=bc on four identities, launch counters zeroed just before and
   read just after (every kernel must have launched), then the same run on
   the plain bf16 path; images and embeddings are checked against f32.

The line before the last is one JSON object with a record per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# Peaks of one H100 SXM (NVIDIA data sheet, dense): HBM3 bytes/s and bf16
# tensor-core FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
REPLACES = {
    "up_fused": "certifyingfacerecognition_tpu/ops/synthesis_tail_bc.py:1205",
    "conv_fused": "certifyingfacerecognition_tpu/ops/synthesis_tail_bc.py:1243",
    "final_stats": "certifyingfacerecognition_tpu/ops/synthesis_tail_bc.py:1279",
    "final_apply": "certifyingfacerecognition_tpu/ops/synthesis_tail_bc.py:1312",
}
SOURCE = "certifyingfacerecognition_torch/csrc/synthesis_tail_bc.cu"
# Kernel vs plain version: max |err| <= TOL * max |plain| (bf16: two bf16
# ulps at the top of the range, for rounding flips of intermediates that
# differ in the last f32 bit; f32: f32 summation order). Sums: each row
# (sum t, sum t^2) against its own largest value, since f32 atomics sum in
# another order on every run.
TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-4}
SUMS_TOL = 1e-4


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def randn(shape, gen, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device="cuda")
            * scale).to(dtype)


def layer_inputs(kind, h, ci, co, b, dtype, gen):
    """Inputs of one tail layer at input size h (weights at trained-like
    equalised-lr scale)."""
    out_h = 2 * h if kind == "up" else h
    ks = (4, 4) if kind == "up" else (3, 3)
    return dict(
        x=randn((h, h, ci, b), gen, dtype=dtype),
        k=randn(ks + (ci, co), gen, (2.0 / (9 * ci)) ** 0.5),
        nb=randn((out_h, out_h, co), gen, 0.1),
        aff=torch.stack([randn((ci, b), gen, 0.2) + 1.0,
                         randn((ci, b), gen, 0.2)]),
        coefs=torch.stack([randn((co, b), gen, 0.2) + 1.0,
                           randn((co, b), gen, 0.2)]),
        w_rgb=randn((co, 3), gen, co ** -0.5), b_rgb=randn((3,), gen, 0.1))


def run_kernel(bc, name, a, apply_aff, plain=False):
    fn = getattr(bc, name + "_ref" if plain else name)
    args = (a["x"], a["k"], a["nb"], a["aff"])
    if name == "final_apply":
        args += (a["coefs"], a["w_rgb"], a["b_rgb"])
    return fn(*args, apply_aff=apply_aff)


def max_err(got, want, tol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = want.abs().max().item()
    return err.max().item(), err.median().item(), scale, \
        err.max().item() <= tol * scale


# (kernel, layer kind, input h, ci, co): the 1024^2 FFHQ tail's layers
LAYERS = [("up_fused", "up", 256, 64, 32), ("conv_fused", "conv", 512, 32, 32),
          ("up_fused", "up", 512, 32, 16),
          ("final_stats", "conv", 1024, 16, 16),
          ("final_apply", "conv", 1024, 16, 16)]


def check_kernels(bc, gen):
    """Phase 3: every kernel against its plain version on the card."""
    worst = {}
    for name, kind, h, ci, co in LAYERS:
        for dtype in (torch.bfloat16, torch.float32):
            for apply_aff in (False, True):
                a = layer_inputs(kind, h, ci, co, 8, dtype, gen)
                got = run_kernel(bc, name, a, apply_aff)
                want = run_kernel(bc, name, a, apply_aff, plain=True)
                torch.cuda.synchronize()
                if name == "final_apply":
                    outs = [("img", got, want, TOL[dtype])]
                else:
                    outs, s, sr = [], got, want
                    if name != "final_stats":
                        outs = [("t", got[0], want[0], TOL[dtype])]
                        s, sr = got[1], want[1]
                    outs += [("s1", s[0], sr[0], SUMS_TOL),
                             ("s2", s[1], sr[1], SUMS_TOL)]
                for what, g, w, tol in outs:
                    mx, med, scale, ok = max_err(g, w, tol)
                    log(f"check {name:11s} h={h:4d} {ci:2d}->{co:2d} "
                        f"{str(dtype)[6:]:8s} aff={int(apply_aff)} {what:4s} "
                        f"max|err| {mx:.3e} median {med:.3e} "
                        f"max|plain| {scale:.3e} tol {tol:.1e}*max|plain| "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{name} disagrees with its "
                                             f"plain version ({what})")
                    # max_abs_err of a kernel: its main output in bf16
                    # (the sums for final_stats, which writes nothing else)
                    if dtype == torch.bfloat16 and \
                            (what[0] != "s" or name == "final_stats"):
                        worst[name] = max(worst.get(name, 0.0), mx)
                del a, got, want
    return worst


def plain_chain(bc, x, blocks, eps=1e-8):
    """The chain of plain versions (reference for tail_chain_bc)."""
    aff = torch.stack([torch.ones(x.shape[2:], device=x.device),
                       torch.zeros(x.shape[2:], device=x.device)])
    cur = x
    for li, blk in enumerate(blocks):
        cur, sums = bc.up_fused_ref(cur, blk["k4"], blk["up_nb"], aff,
                                    apply_aff=li > 0)
        n = cur.shape[0] * cur.shape[1]
        aff = bc.coefs_from_sums(sums, n, blk["up_s0p1"].t(),
                                 blk["up_s1"].t(), eps)
        if li < len(blocks) - 1:
            cur, sums = bc.conv_fused_ref(cur, blk["k"], blk["conv_nb"], aff)
            aff = bc.coefs_from_sums(sums, n, blk["conv_s0p1"].t(),
                                     blk["conv_s1"].t(), eps)
    sums = bc.final_stats_ref(cur, blk["k"], blk["conv_nb"], aff)
    coefs = bc.coefs_from_sums(sums, n, blk["conv_s0p1"].t(),
                               blk["conv_s1"].t(), eps)
    return bc.final_apply_ref(cur, blk["k"], blk["conv_nb"], aff, coefs,
                              blk["w_rgb"], blk["b_rgb"])


def check_chain(bc, gen, b=8):
    """The 512^2 + 1024^2 chain through the kernels vs the plain chain."""
    blocks, h = [], 256
    for cin, cout in ((64, 32), (32, 16)):
        blocks.append({
            "k4": randn((4, 4, cin, cout), gen, (2.0 / (9 * cin)) ** 0.5),
            "up_nb": randn((2 * h, 2 * h, cout), gen, 0.1),
            "up_s0p1": randn((b, cout), gen, 0.2) + 1.0,
            "up_s1": randn((b, cout), gen, 0.2),
            "k": randn((3, 3, cout, cout), gen, (2.0 / (9 * cout)) ** 0.5),
            "conv_nb": randn((2 * h, 2 * h, cout), gen, 0.1),
            "conv_s0p1": randn((b, cout), gen, 0.2) + 1.0,
            "conv_s1": randn((b, cout), gen, 0.2)})
        h *= 2
    blocks[-1]["w_rgb"] = randn((16, 3), gen, 0.25)
    blocks[-1]["b_rgb"] = randn((3,), gen, 0.1)
    x = randn((256, 256, 64, b), gen, dtype=torch.bfloat16)
    got = bc.tail_chain_bc(x, blocks)
    want = plain_chain(bc, x, blocks)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    log(f"check chain 256->1024 bf16 B={b}: image {tuple(got.shape)} "
        f"max|err| {err.max().item():.3e} mean {err.mean().item():.3e} "
        f"max|plain| {want.float().abs().max().item():.3e}")
    # Layers compound: a rounding flip early moves the statistics of every
    # later layer; hold the mean error to a quarter bf16 ulp of the range.
    assert torch.isfinite(got).all() and got.shape == (3, 1024, 1024, b)
    assert err.mean().item() <= 2.0 ** -10 * want.float().abs().max().item()


def cuda_ms(fn, reps=5):
    """Median of `reps` timed calls (CUDA events), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def library_call(name, a):
    """cuDNN's convolution of the layer on the same inputs (bf16, laid out
    channels-last beforehand): the transposed 4x4 conv of an up layer or
    the 3x3 conv of a conv layer, without the blur, the epilogue, the
    sums or the ToRGB that the kernel fuses. The port never calls it."""
    x = a["x"].permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    k = a["k"].to(torch.bfloat16)
    if name == "up_fused":
        wt = torch.flip(k, (0, 1)).permute(2, 3, 0, 1).contiguous()
        return lambda: F.conv_transpose2d(x, wt, stride=2, padding=1)
    w = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(x, w, padding=1)


def bound(name, h, ci, co, b):
    """(bound_ms, bound_by, bytes read, bytes written) of one launch: the
    least time for the bytes the kernel must move (inputs read once,
    outputs written once; bf16 activations and nb, f32 weights, affines
    and sums as the kernel takes them) and for its MACs on the bf16 tensor
    cores (the up layer's transposed conv does 2x2 taps per output)."""
    up = name == "up_fused"
    out_hw = (2 * h) ** 2 if up else h * h
    read = h * h * ci * b * 2 + (16 if up else 9) * ci * co * 4 \
        + out_hw * co * 2 + 2 * ci * b * 4
    write = {"up_fused": out_hw * co * b * 2 + 2 * co * b * 4,
             "conv_fused": out_hw * co * b * 2 + 2 * co * b * 4,
             "final_stats": 2 * co * b * 4,
             "final_apply": 3 * out_hw * b * 2}[name]
    flops = 2.0 * out_hw * b * (4 if up else 9) * ci * co
    if name == "final_apply":
        read += 2 * co * b * 4 + co * 3 * 4 + 3 * 4
        flops += 2.0 * out_hw * b * co * 3
    t_bytes = (read + write) / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), read, write


def time_kernels(bc, gen, gpu, b=128):
    """Phase 4: kernel and plain-version times at the main path's batch."""
    rec = {}
    for name, kind, h, ci, co in LAYERS:
        a = layer_inputs(kind, h, ci, co, b, torch.bfloat16, gen)
        ms = cuda_ms(lambda: run_kernel(bc, name, a, True))
        plain_ms = cuda_ms(lambda: run_kernel(bc, name, a, True, plain=True))
        library_ms = cuda_ms(library_call(name, a))
        bms, by, rd, wr = bound(name, h, ci, co, b)
        log(f"time {name:11s} h={h:4d} {ci:2d}->{co:2d} bf16 B={b}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN conv alone "
            f"{library_ms:.3f} ms, bound {bms:.3f} ms ({by}: "
            f"{rd / 1e9:.2f} GB read + {wr / 1e9:.2f} GB written) [{gpu}]")
        # a kernel launched at two shapes per batch (up_fused) reports the
        # sum over its launches
        r = rec.setdefault(name, dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                                      bound_ms=0.0, bound_by=by))
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["library_ms"] += library_ms
        r["bound_ms"] += bms
        del a
        torch.cuda.empty_cache()
    return rec


def make_data_dir(root, pipe_kwargs):
    """w.npy for four identities from the port's mapping network, and
    their gallery embeddings from the port's own 1024^2 bf16 pipeline."""
    from certifyingfacerecognition_torch.models import iresnet, stylegan
    from certifyingfacerecognition_torch.models.pipeline import FacePipeline
    from certifyingfacerecognition_torch.ops.geometry import get_all_matrices
    from certifyingfacerecognition_torch.utils import weights as W

    mapping = stylegan.random_params(1024, seed=1, realistic=True,
                                     device="cuda")
    z = torch.randn((4, 512), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        w = stylegan.mapping_apply(mapping, z.cuda()).cpu().numpy()
    np.save(os.path.join(root, "w.npy"), w)
    # He-scaled ArcFace weights: the default random:0 ones drive every
    # embedding to NaN through 50 layers
    frm_path = os.path.join(root, "arcface_r50.npz")
    W.save_params(frm_path, iresnet.convert_state_dict_np(
        iresnet.random_torch_style_state_dict("iresnet50", seed=0,
                                              realistic=True)))
    gen = W.load_generator_params("random:0", resolution=1024)
    frm = W.load_frm_params(frm_path)
    dirs = torch.as_tensor(get_all_matrices().dirs.T)
    pipes = {}
    for tag, dtype, tail in (("bc", torch.bfloat16, "bc"),
                             ("plain16", torch.bfloat16, ""),
                             ("f32", torch.float32, "")):
        os.environ["CFR_TAIL"] = tail
        pipes[tag] = FacePipeline(gen, frm, dirs=dirs, resolution=1024,
                                  dtype=dtype, **pipe_kwargs)
    os.environ["CFR_TAIL"] = "bc"
    embs = pipes["bc"].lat2embs(w).float().cpu().numpy()
    np.savez(os.path.join(root, "embs_insightface.npz"), embs=embs)
    return w, frm_path, pipes, gen, embs


def check_outputs(pipes, gen, w, embs_bc):
    """The chain tail's image and embeddings agree with the f32 path as
    closely as the plain bf16 path does (finite, expected shapes)."""
    from certifyingfacerecognition_torch.models import stylegan

    wt = torch.as_tensor(w, device="cuda")
    imgs, embs = {}, {"bc": embs_bc}
    for tag, dtype, tail in (("bc", torch.bfloat16, "bc"),
                             ("plain16", torch.bfloat16, ""),
                             ("f32", torch.float32, "")):
        os.environ["CFR_TAIL"] = tail
        with torch.inference_mode():
            img = stylegan.synthesize_from_w(gen, wt, resolution=1024,
                                             dtype=dtype)
        imgs[tag] = img.float().cpu().numpy()
        if tag != "bc":
            embs[tag] = pipes[tag].lat2embs(w).float().cpu().numpy()
    os.environ["CFR_TAIL"] = "bc"
    assert imgs["bc"].shape == (4, 3, 1024, 1024)
    for tag in embs:
        assert embs[tag].shape == (4, 512) and np.isfinite(embs[tag]).all()
        assert np.isfinite(imgs[tag]).all()
    err = {t: float(np.abs(imgs[t] - imgs["f32"]).mean())
           for t in ("bc", "plain16")}
    cos = {t: float(np.min(np.sum(embs[t] * embs["f32"], 1)
                           / np.linalg.norm(embs[t], axis=1)
                           / np.linalg.norm(embs["f32"], axis=1)))
           for t in ("bc", "plain16")}
    log(f"check 1024^2 images vs f32: mean|err| chain tail {err['bc']:.3e}, "
        f"plain bf16 {err['plain16']:.3e}; embedding min cosine vs f32: "
        f"chain tail {cos['bc']:.5f}, plain bf16 {cos['plain16']:.5f}")
    assert err["bc"] <= 1.5 * err["plain16"] + 1e-4
    assert cos["bc"] >= 0.99


def certify_run(main, root, frm_path, out, tail):
    """One cfr-certify run; returns (rows, samples, seconds summed over
    the TSV's per-identity times)."""
    os.environ["CFR_TAIL"] = tail
    n0, n = 128, 1024
    main(["--face-recog-model", "insightface", "--outfile", out,
          "--sigma", "0.1", "--data-dir", root, "--resolution", "1024",
          "--dtype", "bf16", "--batch-sz", "128", "--N0", str(n0),
          "--N", str(n), "--gen-weights", "random:0",
          "--frm-weights", frm_path, "--seed", "0"])
    torch.cuda.synchronize()
    lines = open(out).read().strip().split("\n")
    assert lines[0] == "idx\tlabel\tpredict\tcorrect\tgap\tradius\ttime"
    rows = [line.split("\t") for line in lines[1:]]
    assert [int(r[0]) for r in rows] == [0, 1, 2, 3], rows
    samples, secs = 0, 0.0
    for r in rows:
        pred = int(r[2])
        assert -1 <= pred < 4, r
        samples += n0 + (n if pred in (-1, int(r[1])) else 0)
        hms, _, frac = r[6].partition(".")
        hh, mm, ss = (int(v) for v in hms.split(":"))
        secs += hh * 3600 + mm * 60 + ss + float("0." + (frac or "0"))
    return rows, samples, secs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    t_start = time.time()
    from certifyingfacerecognition_torch.cli import certify
    from certifyingfacerecognition_torch.ops import kernels
    from certifyingfacerecognition_torch.ops import synthesis_tail_bc as bc

    gpu = gpu_line()
    log(gpu)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    os.environ["CFR_TAIL"] = "bc"
    # plain versions in f32 compare against full-precision convolutions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.time()
    kernels.library("synthesis_tail_bc")
    info = kernels.BUILD_LOG.get("synthesis_tail_bc", {})
    log(f"build: {time.time() - t0:.1f} s ({info.get('cmd', 'cached')})")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = check_kernels(bc, gen)
    check_chain(bc, gen)
    timing = time_kernels(bc, gen, gpu)

    with tempfile.TemporaryDirectory() as root:
        w, frm_path, pipes, gen_params, embs = make_data_dir(root, {})
        check_outputs(pipes, gen_params, w, embs)
        del pipes
        torch.cuda.empty_cache()

        bc.reset_launches()
        rows, samples, secs = certify_run(certify.main, root, frm_path,
                                          os.path.join(root, "bc.tsv"), "bc")
        launches = dict(bc.LAUNCHES)
        log(f"main path (CFR_TAIL=bc): {rows}")
        log(f"main path launches: {launches}")
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main path: "
                                 f"{missing}")
        log(f"main path bf16 chain tail: {samples} samples in {secs:.3f} s "
            f"= {samples / secs:.1f} samples/s [{gpu}]")

        bc.reset_launches()
        rows_p, samples_p, secs_p = certify_run(
            certify.main, root, frm_path, os.path.join(root, "plain.tsv"), "")
        assert all(v == 0 for v in bc.LAUNCHES.values()), bc.LAUNCHES
        log(f"main path (plain bf16): {rows_p}")
        log(f"main path bf16 plain ops: {samples_p} samples in {secs_p:.3f} s "
            f"= {samples_p / secs_p:.1f} samples/s [{gpu}]")

    records = []
    for name in ("up_fused", "conv_fused", "final_stats", "final_apply"):
        t = timing[name]
        records.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    log(f"total: {time.time() - t_start:.1f} s")
    log(gpu_line())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
