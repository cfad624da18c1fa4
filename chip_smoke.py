"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs straight through and raises (exit code != 0) on any failure:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: compiles the hand-written kernels from csrc/ (nvcc, sm_90a),
   prints ptxas's registers and spills, and counts the tensor-core (HMMA)
   instructions of each up_kernel and conv3x3_kernel instantiation in the
   library's SASS (cuobjdump); every bf16 one must have some and no
   spill, every f32 one none;
3. each kernel of the synthesis tail against its plain PyTorch version at
   the 1024^2 tail's shapes (B = 8), bf16 and f32: the four chain kernels
   with and without the input affine (final_stats and final_apply also at
   512^2 32 -> 32, where the cascade's fast pass runs them), the five
   passes of the standalone half-layers, the up layer also at
   CFR_TAIL_MIN_RES=128's first up layer (64^2 -> 128^2, 256 -> 128
   channels) and the conv layers at its widest shapes (128^2 128 -> 128,
   256^2 64 -> 64), and the whole kernel chain against a plain chain;
4. each kernel's time at B = 128 (CUDA events, median of 5) beside its
   plain version's time, its roofline bound and the time of cuDNN's
   convolution of the same layer (the library yardstick);
5. the certify path: ``cfr-certify`` (cli.certify.main) at 1024^2 in bf16
   with CFR_TAIL=bc on four identities, launch counters zeroed just before
   and read just after (every chain kernel must have launched), then the
   same run on the plain bf16 path; images and embeddings are checked
   against f32;
5b. adaptive certification and the reduced-resolution cascade on phase
   5's data (CFR_TAIL=bc, batch 128, N0 = 128, sigma = 0.1): ``cfr-certify
   --adaptive guaranteed`` (N = 1024, one batch per checkpoint, slack 0)
   with the host engine, the device engine and the device engine in
   groups of 4, each TSV equal to phase 5's row for row and every chain
   kernel launched; ``--adaptive sequential`` (N = 4096, device engine)
   with its samples used and seconds per identity; then a 512^2 gallery
   from the port's 512^2 bf16 pipeline, ``--synthesis-resolution 512``
   alone (its samples/s; the 512^2 block alone in the tail: up_fused,
   final_stats and final_apply launch, conv_fused does not) and with
   ``--cascade`` at 1024^2 (every certified row equal to phase 5's; the
   fast pass launches the three, the native pass all four chain kernels);
6. the standalone tail 256^2 -> 1024^2 through the differentiable ops
   (upconv_blur_epilogue_bc -> conv_epilogue_bc -> upconv_blur_epilogue_bc
   -> conv_epilogue_rgb_bc): bf16 image against the plain references, the
   f32 gradient against the plain references' gradient, every standalone
   kernel launched;
7. the attack path: ``cfr-attack-torch --attack-type manual`` (cli.
   main_attack.main) at 1024^2, bf16, 48 identities, batch 48, with
   CFR_TAIL=bc (chain counters > 0) and on plain bf16 ops (counters 0),
   then --eval-files; artifacts, feasibility and re-verification checked;
   the gradients of the attack loss and of an image loss with respect to
   the deltas through the chain tail at B = 4, each held to f32 as closely
   as the plain bf16 path's; seconds per PGD iteration (forward,
   backward) at batch 48 for both paths.
8. and 9. FaceNet certify and the AutoAttack family (check_facenet,
   check_autoattack);
10. identity generation at 1024^2, ``cfr-generate-data-torch``: StyleGAN
   through the chain kernels, on plain bf16 and in fp32, PGGAN in bf16
   and fp32; codes, images and PNGs checked (check_generation);
11. ``cfr-certify-torch --mesh`` on a one-rank NCCL group in this
   process, each TSV equal to phase 5's (check_mesh).

The line before the last is one JSON object with a record per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
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
_TPU = "certifyingfacerecognition_tpu/ops/synthesis_tail_bc.py:"
REPLACES = {
    "up_fused": _TPU + "1205", "conv_fused": _TPU + "1243",
    "final_stats": _TPU + "1279", "final_apply": _TPU + "1312",
    "conv_stats": _TPU + "413", "conv_apply": _TPU + "435",
    "conv_rgb_apply": _TPU + "453", "up_stats": _TPU + "577",
    "up_apply": _TPU + "594",
}
CHAIN = ("up_fused", "conv_fused", "final_stats", "final_apply")
STANDALONE = ("conv_stats", "conv_apply", "conv_rgb_apply", "up_stats",
              "up_apply")
SOURCE = "certifyingfacerecognition_torch/csrc/synthesis_tail_bc.cu"
# Kernel vs plain version: max |err| <= TOL * max |plain| (bf16: two bf16
# ulps at the top of the range, for rounding flips of intermediates that
# differ in the last f32 bit; f32: f32 summation order). Sums: each row
# (sum t, sum t^2) against its own largest value, since the kernels sum in
# another order than the plain version (and in 2^-20 fixed point).
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


def run_kernel(bc, name, a, apply_aff=True, plain=False):
    """One call of kernel ``name`` (or its plain version) on the layer
    inputs ``a``; the standalone passes take no input affine."""
    fn = getattr(bc, name + "_ref" if plain else name)
    if name in CHAIN:
        args = (a["x"], a["k"], a["nb"], a["aff"])
        if name == "final_apply":
            args += (a["coefs"], a["w_rgb"], a["b_rgb"])
        return fn(*args, apply_aff=apply_aff)
    args = (a["x"], a["k"], a["nb"])
    if name.endswith("apply"):
        args += (a["coefs"],)
    if name == "conv_rgb_apply":
        args += (a["w_rgb"], a["b_rgb"])
    return fn(*args)


def kernel_outputs(name, got, want, dtype):
    """(what, kernel output, plain output, tolerance) per output: images
    and activations to TOL, each row of the sums to SUMS_TOL."""
    if name in ("up_fused", "conv_fused"):
        outs, got, want = [("t", got[0], want[0], TOL[dtype])], got[1], \
            want[1]
    elif name.endswith("stats"):
        outs = []
    else:
        return [("img" if "rgb" in name or name == "final_apply" else "out",
                 got, want, TOL[dtype])]
    return outs + [("s1", got[0], want[0], SUMS_TOL),
                   ("s2", got[1], want[1], SUMS_TOL)]


def max_err(got, want, tol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = want.abs().max().item()
    return err.max().item(), err.median().item(), scale, \
        err.max().item() <= tol * scale


# (kernel, layer kind, input h, ci, co): the 1024^2 FFHQ tail's layers,
# as the chain runs them and as the standalone half-layers run them
LAYERS = [("up_fused", "up", 256, 64, 32), ("conv_fused", "conv", 512, 32, 32),
          ("up_fused", "up", 512, 32, 16),
          ("final_stats", "conv", 1024, 16, 16),
          ("final_apply", "conv", 1024, 16, 16)]
STANDALONE_LAYERS = [
    ("up_stats", "up", 256, 64, 32), ("up_apply", "up", 256, 64, 32),
    ("conv_stats", "conv", 512, 32, 32), ("conv_apply", "conv", 512, 32, 32),
    ("up_stats", "up", 512, 32, 16), ("up_apply", "up", 512, 32, 16),
    ("conv_stats", "conv", 1024, 16, 16),
    ("conv_rgb_apply", "conv", 1024, 16, 16)]
# checked, not timed: the first up layer of CFR_TAIL_MIN_RES=128's tail,
# where the bf16 kernel stages its input in chunks of 32 channels
WIDE_UP_LAYERS = [("up_fused", "up", 64, 256, 128),
                  ("up_stats", "up", 64, 256, 128),
                  ("up_apply", "up", 64, 256, 128)]
# checked, not timed: the conv layers of CFR_TAIL_MIN_RES=128's tail at
# 128^2 and 256^2, where the bf16 kernel stages its input in chunks of 16
# channels and the widest conv shape (Ci = Co = 128) is reached
WIDE_CONV_LAYERS = [(name, "conv", h, c, c) for h, c in ((128, 128),
                                                         (256, 64))
                    for name in ("conv_fused", "final_stats", "final_apply",
                                 "conv_stats", "conv_apply",
                                 "conv_rgb_apply")]


# checked, not timed: the last layer of a 512^2 synthesis (the cascade's
# fast pass), run by final_stats and final_apply at 32 -> 32
FAST_PASS_LAYERS = [(name, "conv", 512, 32, 32)
                    for name in ("final_stats", "final_apply")]


def check_kernels(bc, gen):
    """Phase 3: every kernel against its plain version on the card."""
    worst = {}
    wide = WIDE_UP_LAYERS + WIDE_CONV_LAYERS + FAST_PASS_LAYERS
    cases = [(L, aff) for L in LAYERS + wide
             if L[0] in CHAIN for aff in (False, True)] + \
        [(L, False) for L in STANDALONE_LAYERS + wide
         if L[0] in STANDALONE]
    for (name, kind, h, ci, co), apply_aff in cases:
        for dtype in (torch.bfloat16, torch.float32):
            a = layer_inputs(kind, h, ci, co, 8, dtype, gen)
            got = run_kernel(bc, name, a, apply_aff)
            want = run_kernel(bc, name, a, apply_aff, plain=True)
            torch.cuda.synchronize()
            for what, g, w, tol in kernel_outputs(name, got, want, dtype):
                mx, med, scale, ok = max_err(g, w, tol)
                log(f"check {name:14s} h={h:4d} {ci:3d}->{co:3d} "
                    f"{str(dtype)[6:]:8s} aff={int(apply_aff)} {what:4s} "
                    f"max|err| {mx:.3e} median {med:.3e} "
                    f"max|plain| {scale:.3e} tol {tol:.1e}*max|plain| "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its "
                                         f"plain version ({what})")
                # max_abs_err of a kernel: its main output in bf16 (the
                # sums for a stats pass, which writes nothing else)
                if dtype == torch.bfloat16 and \
                        (what[0] != "s" or name.endswith("stats")):
                    worst[name] = max(worst.get(name, 0.0), mx)
            del a, got, want
    return worst


_KERNEL_NAME = re.compile(
    r"(up_kernel|conv3x3_kernel)I(13__nv_bfloat16|f)Li(\d)ELb(\d)E")


def _kernel_name(mangled):
    """"conv3x3_kernel<bf16, MODE 0, AFF 1>" for a mangled instantiation of
    up_kernel or conv3x3_kernel, else None."""
    m = _KERNEL_NAME.search(mangled)
    return None if m is None else (
        f"{m[1]}<{'bf16' if m[2] != 'f' else 'f32'}, MODE {m[3]}, "
        f"AFF {m[4]}>")


def kernel_hmma(lib_path):
    """{"up_kernel<T, MODE, AFF>" or "conv3x3_kernel<...>": HMMA
    instructions} of every instantiation in the built library's SASS
    (cuobjdump -sass)."""
    from certifyingfacerecognition_torch.ops import kernels

    sass = subprocess.run([kernels.cuda_tool("cuobjdump"), "-sass",
                           str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = _kernel_name(line)
            if fn is not None:
                counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def kernel_spills(ptxas_log):
    """{kernel instantiation: (registers, spill store bytes, spill load
    bytes)} from nvcc's -Xptxas -v log."""
    out, fn = {}, None
    for line in ptxas_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = _kernel_name(m[1])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            out[fn] = [0, int(m[1]), int(m[2])]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn in out:
            out[fn][0] = int(m[1])
            fn = None
    return {k: tuple(v) for k, v in out.items()}


def check_build(kernels):
    """Phase 2: build the library (again, if it was cached, for ptxas's
    log), then every bf16 instantiation of both kernels must hold HMMA
    instructions and spill nothing, and every f32 one hold none."""
    t0 = time.time()
    path = kernels.build("synthesis_tail_bc")
    if "synthesis_tail_bc" not in kernels.BUILD_LOG:
        path = kernels.build("synthesis_tail_bc", force=True)
    kernels.library("synthesis_tail_bc")
    info = kernels.BUILD_LOG["synthesis_tail_bc"]
    log(f"build: {time.time() - t0:.1f} s ({info['cmd']})")
    spills = kernel_spills(info["log"])
    hmma = kernel_hmma(path)
    for fn in sorted(hmma):
        regs, st, ld = spills.get(fn, (None, None, None))
        log(f"  {fn}: {hmma[fn]} HMMA instructions, {regs} registers, "
            f"spill stores {st} B, loads {ld} B")
    kinds = {(fn.split("<")[0], "bf16" in fn) for fn in hmma}
    if kinds != {(k, tc) for k in ("up_kernel", "conv3x3_kernel")
                 for tc in (False, True)}:
        raise AssertionError(f"kernel instantiations missing: {hmma}")
    bad = [fn for fn, n in hmma.items() if (n > 0) != ("bf16" in fn)]
    # an instantiation missing from ptxas's log counts as spilling
    bad += [fn for fn in hmma if "bf16" in fn
            and spills.get(fn, (0, 1, 1))[1:] != (0, 0)]
    if bad:
        raise AssertionError(f"a bf16 kernel without tensor-core "
                             f"instructions or with a spill, or an f32 one "
                             f"with them: {bad}")


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


def tail_blocks(gen, b):
    """Random blocks of the 1024^2 tail (512^2 64->32, 1024^2 32->16) at
    trained-like scales."""
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
    return blocks


def check_chain(bc, gen, b=8):
    """The 512^2 + 1024^2 chain through the kernels vs the plain chain;
    two runs of the kernels must agree bit for bit."""
    blocks = tail_blocks(gen, b)
    x = randn((256, 256, 64, b), gen, dtype=torch.bfloat16)
    got = bc.tail_chain_bc(x, blocks)
    again = bc.tail_chain_bc(x, blocks)
    want = plain_chain(bc, x, blocks)
    torch.cuda.synchronize()
    # the fixed-point sums make the kernels deterministic: a rerun gives the
    # same bits (f32 atomics did not, and a re-verified adversary could
    # flip)
    if not torch.equal(got, again):
        raise AssertionError("tail_chain_bc is not deterministic")
    err = (got.float() - want.float()).abs()
    log(f"check chain 256->1024 bf16 B={b}: image {tuple(got.shape)} "
        f"max|err| {err.max().item():.3e} mean {err.mean().item():.3e} "
        f"max|plain| {want.float().abs().max().item():.3e}")
    # Layers compound: a rounding flip early moves the statistics of every
    # later layer; hold the mean error to a quarter bf16 ulp of the range.
    assert torch.isfinite(got).all() and got.shape == (3, 1024, 1024, b)
    assert err.mean().item() <= 2.0 ** -10 * want.float().abs().max().item()


STYLES = ("up_s0p1", "up_s1", "conv_s0p1", "conv_s1")


def standalone_tail(bc, x, blocks, eps=1e-8):
    """The tail through the standalone differentiable ops."""
    b0, b1 = blocks
    y = bc.upconv_blur_epilogue_bc(x, b0["k4"], b0["up_nb"], b0["up_s0p1"],
                                   b0["up_s1"], eps)
    y = bc.conv_epilogue_bc(y, b0["k"], b0["conv_nb"], b0["conv_s0p1"],
                            b0["conv_s1"], eps)
    y = bc.upconv_blur_epilogue_bc(y, b1["k4"], b1["up_nb"], b1["up_s0p1"],
                                   b1["up_s1"], eps)
    return bc.conv_epilogue_rgb_bc(y, b1["k"], b1["conv_nb"],
                                   b1["conv_s0p1"], b1["conv_s1"],
                                   b1["w_rgb"], b1["b_rgb"], eps)


def check_standalone_tail(bc, gen, b=8):
    """Phase 6: the standalone half-layers 256^2 -> 1024^2, forward in bf16
    (every standalone kernel must launch; the image must track the f32
    plain references as closely as the bf16 plain references do) and the
    f32 gradient with respect to x and the styles against the gradient
    through the plain references. Returns the launch counts."""
    blocks = tail_blocks(gen, b)
    x = randn((256, 256, 64, b), gen)
    bc.reset_launches()
    img = standalone_tail(bc, x.bfloat16(), blocks)
    torch.cuda.synchronize()
    launches = {k: bc.LAUNCHES[k] for k in STANDALONE}
    log(f"standalone tail launches: {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"standalone kernels never launched: {missing}")
    with torch.no_grad():
        ref16 = bc._chain_ref(x.bfloat16(), blocks, 1e-8).float()
        ref32 = bc._chain_ref(x, blocks, 1e-8)
    err_k = (img.float() - ref32).abs().mean().item()
    err_p = (ref16 - ref32).abs().mean().item()
    log(f"check standalone tail bf16 B={b}: image {tuple(img.shape)} mean "
        f"|err| vs f32 references: kernels {err_k:.3e}, plain bf16 "
        f"references {err_p:.3e} (max|f32| "
        f"{ref32.abs().max().item():.3e})")
    assert torch.isfinite(img).all() and img.shape == (3, 1024, 1024, b)
    assert err_k <= 1.5 * err_p + 1e-4

    xg = x.clone().requires_grad_()
    bg = [{k: v.clone().requires_grad_(k in STYLES) for k, v in blk.items()}
          for blk in blocks]
    leaves = [xg] + [blk[k] for blk in bg for k in STYLES]
    cot = randn((3, 1024, 1024, b), gen)
    got = torch.autograd.grad((standalone_tail(bc, xg, bg) * cot).sum(),
                              leaves)
    want = torch.autograd.grad((bc._chain_ref(xg, bg, 1e-8) * cot).sum(),
                               leaves)
    for name, g, w in zip(["x"] + [f"{k}[{i}]" for i in range(2)
                                   for k in STYLES], got, want):
        rel = ((g - w).abs().mean() / w.abs().mean()).item()
        log(f"check standalone tail f32 gradient d/d{name}: mean|err| / "
            f"mean|plain| {rel:.3e}, max|err| "
            f"{(g - w).abs().max().item():.3e} of max|plain| "
            f"{w.abs().max().item():.3e}")
        # f32. The kernels' forward and the references' differ in f32
        # rounding, so pre-activations within rounding of 0 (hundreds of
        # them in the 1024^2 layers) take the other lrelu branch, and a
        # style's gradient sums over every pixel: 1e-3 of the mean was
        # measured for the first layer's s0p1 on an H100. A gradient routed
        # to the wrong input or not at all is off by O(1).
        assert torch.isfinite(g).all() and rel <= 1e-2
    return launches


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
    if name.startswith("up"):
        wt = torch.flip(k, (0, 1)).permute(2, 3, 0, 1).contiguous()
        return lambda: F.conv_transpose2d(x, wt, stride=2, padding=1)
    w = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(x, w, padding=1)


def bound(name, h, ci, co, b):
    """(bound_ms, bytes ms, operations ms, bytes read, bytes written) of
    one launch: the least time for the bytes the kernel must move (inputs
    read once, outputs written once; bf16 activations, nb and packed
    weights, f32 affines, coefs and sums as the kernel takes them) and for
    its MACs on the bf16 tensor cores (the up layer's transposed conv does
    2x2 taps per output). A standalone pass reads no input affine; a stats
    pass writes only its sums."""
    up = name.startswith("up")
    out_hw = (2 * h) ** 2 if up else h * h
    read = h * h * ci * b * 2 + (16 if up else 9) * ci * co * 2 \
        + out_hw * co * 2 + (2 * ci * b * 4 if name in CHAIN else 0)
    sums = 2 * co * b * 4
    write = {"up_fused": out_hw * co * b * 2 + sums,
             "conv_fused": out_hw * co * b * 2 + sums,
             "final_stats": sums, "conv_stats": sums, "up_stats": sums,
             "conv_apply": out_hw * co * b * 2,
             "up_apply": out_hw * co * b * 2,
             "final_apply": 3 * out_hw * b * 2,
             "conv_rgb_apply": 3 * out_hw * b * 2}[name]
    flops = 2.0 * out_hw * b * (4 if up else 9) * ci * co
    if name.endswith("apply"):
        read += 2 * co * b * 4                       # the coefs
    if name in ("final_apply", "conv_rgb_apply"):
        read += co * 3 * 4 + 3 * 4
        flops += 2.0 * out_hw * b * co * 3
    t_bytes = (read + write) / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16 * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops, read, write


def time_kernels(bc, gen, gpu, b=128):
    """Phase 4: kernel and plain-version times at the main path's batch.
    A kernel launched at two shapes (up_fused, up_stats, up_apply,
    conv_stats) reports the sum over its launches; its bound_by is the
    larger of its summed byte time and summed operation time."""
    rec = {}
    for name, kind, h, ci, co in LAYERS + STANDALONE_LAYERS:
        a = layer_inputs(kind, h, ci, co, b, torch.bfloat16, gen)
        ms = cuda_ms(lambda: run_kernel(bc, name, a))
        plain_ms = cuda_ms(lambda: run_kernel(bc, name, a, plain=True))
        library_ms = cuda_ms(library_call(name, a))
        bms, tb, to, rd, wr = bound(name, h, ci, co, b)
        by = "bytes" if tb >= to else "operations"
        log(f"time {name:14s} h={h:4d} {ci:2d}->{co:2d} bf16 B={b}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN conv alone "
            f"{library_ms:.3f} ms, bound {bms:.3f} ms ({by}: "
            f"{rd / 1e9:.2f} GB read + {wr / 1e9:.2f} GB written, "
            f"{to:.3f} ms of MACs) [{gpu}]")
        r = rec.setdefault(name, dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                                      bound_ms=0.0, t_bytes=0.0, t_ops=0.0))
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["library_ms"] += library_ms
        r["bound_ms"] += bms
        r["t_bytes"] += tb
        r["t_ops"] += to
        del a
        torch.cuda.empty_cache()
    for r in rec.values():
        r["bound_by"] = "bytes" if r.pop("t_bytes") >= r.pop("t_ops") \
            else "operations"
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


def row_seconds(row):
    """Seconds of a TSV row's time column (h:mm:ss[.ffffff])."""
    hms, _, frac = row[6].partition(".")
    hh, mm, ss = (int(v) for v in hms.split(":"))
    return hh * 3600 + mm * 60 + ss + float("0." + (frac or "0"))


def certify_run(main, root, frm_path, out, tail, n=1024, extra=(),
                model="insightface"):
    """One cfr-certify run (its standard output echoed); returns (rows,
    samples, seconds summed over the TSV's per-identity times, {identity:
    samples used} from an adaptive run's lines). ``samples`` counts a
    fixed-N run's: N0, plus N for an identity that passed selection."""
    os.environ["CFR_TAIL"] = tail
    n0 = 128
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--face-recog-model", model, "--outfile", out,
              "--sigma", "0.1", "--data-dir", root, "--resolution", "1024",
              "--dtype", "bf16", "--batch-sz", "128", "--N0", str(n0),
              "--N", str(n), "--gen-weights", "random:0",
              "--frm-weights", frm_path, "--seed", "0", *extra])
    torch.cuda.synchronize()
    for line in buf.getvalue().splitlines():
        log(line)
    used = {int(m[1]): int(m[2]) for m in re.finditer(
        r"adaptive\[\w+\] id (\d+): (\d+)/", buf.getvalue())}
    lines = open(out).read().strip().split("\n")
    assert lines[0] == "idx\tlabel\tpredict\tcorrect\tgap\tradius\ttime"
    rows = [line.split("\t") for line in lines[1:]]
    assert [int(r[0]) for r in rows] == [0, 1, 2, 3], rows
    samples = 0
    for r in rows:
        pred = int(r[2])
        assert -1 <= pred < 4, r
        samples += n0 + (n if pred in (-1, int(r[1])) else 0)
    return rows, samples, sum(row_seconds(r) for r in rows), used


def tsv_columns(rows):
    """The idx, label, predict, correct, gap and radius columns."""
    return [r[:6] for r in rows]


def chain_launches(bc):
    return {k: bc.LAUNCHES[k] for k in CHAIN}


@contextlib.contextmanager
def launches_by_smoother(bc):
    """Chain-kernel launches of each Smooth's certify calls, one dict per
    Smooth in the order of their first call (the cascade's fast pass,
    then its native pass)."""
    from certifyingfacerecognition_torch.smoothing.smooth import Smooth

    certify, by_smoother = Smooth.certify, {}

    def counted(self, *args, **kwargs):
        before = chain_launches(bc)
        out = certify(self, *args, **kwargs)
        counts = by_smoother.setdefault(id(self), dict.fromkeys(CHAIN, 0))
        for k in CHAIN:
            counts[k] += bc.LAUNCHES[k] - before[k]
        return out

    Smooth.certify = counted
    try:
        yield by_smoother
    finally:
        Smooth.certify = certify


def check_adaptive(main, bc, root, frm_path, rows_bc, gpu):
    """Phase 5b, adaptive certification through the chain kernels."""
    out = os.path.join(root, "adaptive.tsv")
    per_id = {}
    for engine, flags in (
            ("host", ["--adaptive-engine", "host"]),
            ("device", ["--adaptive-engine", "device"]),
            ("device, group 4", ["--adaptive-engine", "device",
                                 "--adaptive-group", "4"])):
        bc.reset_launches()
        rows, _, secs, used = certify_run(
            main, root, frm_path, out, "bc",
            extra=["--adaptive", "guaranteed", "--adaptive-chunk-batches",
                   "1", "--adaptive-slack", "0", *flags])
        launches = chain_launches(bc)
        log(f"adaptive guaranteed ({engine} engine): {rows}; samples used "
            f"{used}; launches {launches}")
        if tsv_columns(rows) != tsv_columns(rows_bc):
            raise AssertionError(f"adaptive guaranteed ({engine}) at slack "
                                 f"0 differs from the fixed-N rows")
        if not all(launches.values()):
            raise AssertionError(f"chain kernels not launched: {launches}")
        per_id[engine] = secs / len(rows)
    log("adaptive guaranteed N = 1024, slack 0, s/identity: " + ", ".join(
        f"{k} engine {v:.3f}" for k, v in per_id.items()) + f" [{gpu}]")

    bc.reset_launches()
    n = 4096
    rows, _, _, used = certify_run(
        main, root, frm_path, out, "bc", n=n,
        extra=["--adaptive", "sequential", "--adaptive-chunk-batches", "1",
               "--adaptive-engine", "device"])
    launches = chain_launches(bc)
    if not all(launches.values()):
        raise AssertionError(f"chain kernels not launched: {launches}")
    for r in rows:
        log(f"adaptive sequential N = {n} (device engine) id {r[0]}: "
            f"{used[int(r[0])]}/{128 + n} samples, {row_seconds(r):.3f} s, "
            f"predict {r[2]} gap {r[4]} [{gpu}]")


def check_cascade(main, bc, root, frm_path, w, rows_bc, rate_bc, gpu):
    """Phase 5b, the reduced-resolution fast path and the cascade."""
    from certifyingfacerecognition_torch.models.pipeline import FacePipeline
    from certifyingfacerecognition_torch.ops.geometry import get_all_matrices
    from certifyingfacerecognition_torch.utils import weights as W

    os.environ["CFR_TAIL"] = "bc"
    pipe = FacePipeline(W.load_generator_params("random:0", resolution=1024),
                        W.load_frm_params(frm_path),
                        dirs=torch.as_tensor(get_all_matrices().dirs.T),
                        resolution=512, dtype=torch.bfloat16)
    embs = pipe.lat2embs(w).float().cpu().numpy()
    assert embs.shape == (4, 512) and np.isfinite(embs).all()
    np.savez(os.path.join(root, "embs_insightface_sr512.npz"), embs=embs)
    del pipe

    out = os.path.join(root, "sr512.tsv")
    bc.reset_launches()
    rows, samples, secs, _ = certify_run(
        main, root, frm_path, out, "bc",
        extra=["--synthesis-resolution", "512"])
    launches = chain_launches(bc)
    log(f"certify --synthesis-resolution 512: {rows}; launches {launches}")
    if not all(launches[k] for k in ("up_fused", "final_stats",
                                     "final_apply")) or launches["conv_fused"]:
        raise AssertionError(f"the 512^2 tail is one up layer, then "
                             f"final_stats and final_apply: {launches}")
    log(f"certify bf16 chain tail: --synthesis-resolution 512 {samples} "
        f"samples in {secs:.3f} s = {samples / secs:.1f} samples/s, "
        f"1024^2 (phase 5) {rate_bc:.1f} samples/s [{gpu}]")

    with launches_by_smoother(bc) as by_smoother:
        rows, _, _, _ = certify_run(
            main, root, frm_path, out, "bc",
            extra=["--synthesis-resolution", "512", "--cascade"])
    passes = list(by_smoother.values())
    log(f"certify --synthesis-resolution 512 --cascade: {rows}; launches "
        f"of the fast pass {passes[0]}, of the native pass "
        f"{passes[1:] or 'none'}")
    certified = tsv_columns(r for r in rows if r[3] == "1")
    if not certified or certified != tsv_columns(
            r for r in rows_bc if r[0] in {c[0] for c in certified}):
        raise AssertionError("the cascade's certified rows differ from the "
                             "native run's")
    fast, native = passes
    if not all(fast[k] for k in ("up_fused", "final_stats", "final_apply")) \
            or not all(native.values()):
        raise AssertionError(f"chain kernels not launched: {passes}")


ATTACK_IDS = 48          # identities of the attack run = its batch
# --scale-factor of the attack runs: semi-axes 10x the attribute budgets,
# so that on random weights about a fifth of the identities turn into
# adversaries (the feasibility and re-verification checks have something
# to check) and the rest do not; the compute is the same at any scale
ATTACK_SCALE = 1e-2


def attack_data_dir(root):
    """w.npy for ATTACK_IDS identities from the port's mapping network
    (the attack CLI computes their gallery on its first run)."""
    from certifyingfacerecognition_torch.models import stylegan

    os.makedirs(root, exist_ok=True)
    mapping = stylegan.random_params(1024, seed=1, realistic=True,
                                     device="cuda")
    z = torch.randn((ATTACK_IDS, 512),
                    generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        w = stylegan.mapping_apply(mapping, z.cuda()).cpu().numpy()
    np.save(os.path.join(root, "w.npy"), w)
    return w


def scaled_frm(frm_path, w, out_path, target=25.0):
    """The phase-5 ArcFace weights with the final feature affine scaled so
    that the mean embedding norm of the first identities of ``w`` is
    ``target``. The unscaled He-scaled random weights give embedding norms
    of ~5e6 and gallery distances of ~2e6, where the attack's softmax over
    -d/512 is one-hot in f32 and every gradient of its loss is exactly 0;
    scaled, the distances are tens. Returns the scale factor."""
    from certifyingfacerecognition_torch.models.pipeline import make_lat2embs
    from certifyingfacerecognition_torch.utils import weights as W

    params = W.load_params(frm_path, device="cuda")
    gen = W.load_generator_params("random:0", resolution=1024, device="cuda")
    with torch.inference_mode():
        e = make_lat2embs("insightface", 1024)(
            gen, params, torch.as_tensor(w[:8], device="cuda"))
    c = target / e.norm(dim=1).mean().item()
    params["features"]["scale"] *= c
    params["features"]["shift"] *= c
    W.save_params(out_path, params)
    return c


def check_facenet(main, bc, root, w, gen_params, gpu):
    """Phase 8, FaceNet certify at 1024^2 through the chain kernels:
    FaceNet (InceptionResnetV1 at 160^2, random:0 weights, full widths)
    embeds phase 5's latents three ways (bf16 through the chain tail, plain
    bf16, f32): the chain path's mean |error| against f32 must be at most
    twice the plain bf16 path's. Its gallery, from the chain path, then
    serves cfr-certify --face-recog-model facenet with phase 5's settings,
    with CFR_TAIL=bc (all four chain counters must rise) and on plain bf16
    (none may). On random weights FaceNet's embeddings of different faces
    are nearly equal, so the rows are printed, not compared. Returns the
    bc run's launches."""
    from certifyingfacerecognition_torch.models.pipeline import FacePipeline
    from certifyingfacerecognition_torch.ops.geometry import get_all_matrices
    from certifyingfacerecognition_torch.utils import weights as W

    frm = W.load_frm_params("random:0", "facenet")
    dirs = torch.as_tensor(get_all_matrices().dirs.T)
    embs = {}
    for tag, dtype, tail in (("bc", torch.bfloat16, "bc"),
                             ("plain16", torch.bfloat16, ""),
                             ("f32", torch.float32, "")):
        os.environ["CFR_TAIL"] = tail
        bc.reset_launches()
        pipe = FacePipeline(gen_params, frm, dirs=dirs, frs_method="facenet",
                            resolution=1024, dtype=dtype)
        embs[tag] = pipe.lat2embs(w).float().cpu().numpy()
        launches = chain_launches(bc)
        if (tag == "bc") != all(launches.values()):
            raise AssertionError(f"FaceNet embed ({tag}): launches "
                                 f"{launches}")
        del pipe
    os.environ["CFR_TAIL"] = "bc"
    for tag, e in embs.items():
        assert e.shape == (4, 512) and np.isfinite(e).all(), tag
        assert np.allclose(np.linalg.norm(e, axis=1), 1.0, atol=1e-3), tag
    err = {t: np.abs(embs[t] - embs["f32"]) for t in ("bc", "plain16")}
    log(f"check FaceNet 1024^2 embeddings vs f32: mean|err| chain tail "
        f"{err['bc'].mean():.3e} (max {err['bc'].max():.3e}), plain bf16 "
        f"{err['plain16'].mean():.3e} (max {err['plain16'].max():.3e}); "
        f"largest difference between two identities' f32 embeddings "
        f"{np.abs(embs['f32'][:, None] - embs['f32'][None]).max():.3e}")
    if err["bc"].mean() > 2 * err["plain16"].mean():
        raise AssertionError("the chain tail's FaceNet embeddings are more "
                             "than twice as far from f32 as plain bf16's")
    np.savez(os.path.join(root, "embs_facenet.npz"), embs=embs["bc"])
    torch.cuda.empty_cache()

    rates = {}
    for tag, tail in (("bc", "bc"), ("plain16", "")):
        bc.reset_launches()
        rows, samples, secs, _ = certify_run(
            main, root, "random:0", os.path.join(root, f"facenet_{tag}.tsv"),
            tail, model="facenet")
        launches = chain_launches(bc)
        log(f"certify --face-recog-model facenet ({tag}): {rows}; launches "
            f"{launches}")
        if (tag == "bc" and not all(launches.values())) or \
                (tag != "bc" and any(bc.LAUNCHES.values())):
            raise AssertionError(f"FaceNet certify ({tag}): launches "
                                 f"{dict(bc.LAUNCHES)}")
        rates[tag] = samples / secs
        if tag == "bc":
            bc_launches = launches
        log(f"certify FaceNet bf16 "
            f"{'chain tail' if tag == 'bc' else 'plain ops'}: {samples} "
            f"samples in {secs:.3f} s = {rates[tag]:.1f} samples/s [{gpu}]")
        torch.cuda.empty_cache()
    return bc_launches


def attack_run(main, data, frm_path, out, tail, load_embs):
    """One cfr-attack-torch run (PGD, 1024^2, bf16, one chunk of
    ATTACK_IDS identities at batch ATTACK_IDS, 1 restart x 3 iterations,
    --scale-factor ATTACK_SCALE); returns its wall time in seconds."""
    os.environ["CFR_TAIL"] = tail
    t0 = time.time()
    main(["--output-dir", out, "--data-dir", data, "--attack-type",
          "manual", "--face-recog-method", "insightface", "--dtype", "bf16",
          "--resolution", "1024", "--chunks", "1", "--num-chunk", "0",
          "--batch-size", str(ATTACK_IDS), "--restarts", "1", "--iters", "3",
          "--gen-weights", "random:0", "--frm-weights", frm_path,
          "--scale-factor", str(ATTACK_SCALE), "--seed", "0"]
         + (["--load-embs"] if load_embs else []))
    torch.cuda.synchronize()
    return time.time() - t0


def check_attack_artifacts(out, w, region, predict, params, chunk="0of1",
                           n_ids=ATTACK_IDS, batch=ATTACK_IDS, bounded=True):
    """The chunk log and data parse; every saved success is still
    misclassified when re-synthesised and re-classified, and, for a
    bounded attack, feasible (magnitudes through attacks/pgd.check_deltas
    at most 1 + 1e-3). Returns (log stats, the saved magnitudes)."""
    from certifyingfacerecognition_torch.attacks.pgd import (
        assert_deltas_feasible, check_deltas)
    from certifyingfacerecognition_torch.eval import artifacts

    stats = artifacts.parse_chunk_log(
        os.path.join(out, "logs", f"results_chunk{chunk}.txt"))
    assert sorted(stats) == ["avg_mags", "instances", "successes"], stats
    assert int(stats["instances"]) == n_ids
    n = int(stats["successes"])
    data_file = os.path.join(out, "results", f"results_chunk{chunk}.npz")
    if n == 0:
        assert not os.path.exists(data_file)
        return stats, np.zeros(0)
    data = artifacts.load_chunk_data(data_file)
    idx, deltas = data["successes"], data["deltas"]
    assert len(idx) == n and deltas.shape == (n, region.dirs.shape[1])
    d = torch.as_tensor(deltas, device="cuda")
    mags = check_deltas(d, region).cpu().numpy()
    if bounded:
        assert np.all(mags <= 1.0 + 1e-3), mags
        assert np.all(data["magnitudes"] <= 1.0 + 1e-3)
        assert_deltas_feasible(d, region)
    # zero-padded batches of the attack's size, as the CLI re-verifies: in
    # bf16 another batch shape may round a borderline identity the other
    # way
    adv = torch.as_tensor(w[idx], device="cuda") + d @ region.dirs.t()
    preds = []
    for s in range(0, n, batch):
        b = adv[s:s + batch]
        b = torch.cat([b, b.new_zeros((batch - len(b), b.shape[1]))])
        preds.append(predict(params, b)[:min(batch, n - s)].cpu().numpy())
    preds = np.concatenate(preds)
    assert np.all(preds != idx), (preds, idx)
    return stats, mags


# Phase 9: the AutoAttack family, one chunk of AA_IDS of the attack data's
# identities at batch AA_IDS, the full gallery of ATTACK_IDS
AA_IDS = 16
AA_FLAGS = ["--batch-size", str(AA_IDS), "--iters", "3", "--restarts", "1",
            "--n-target-classes", "2", "--autoattack-iters", "3",
            "--square-queries", "20", "--apgd-use-cli-iters"]
AA_RUNS = (("apgd-ce", ()), ("apgd-t", ()), ("fab-t", ()), ("square", ()),
           ("autoattack", ()), ("autoattack", ("--run-checks",)))
AA_BOUNDED = ("apgd-ce", "apgd-t", "square")


def check_autoattack(main, bc, data, frm_path, w, region, params, gpu):
    """Phase 9 (cwd: the attack runs' root): cfr-attack-torch at 1024^2
    bf16 with CFR_TAIL=bc for each attack of AA_RUNS, counters zeroed just
    before each run and read just after (all four chain kernels must have
    launched); every saved success re-verified, APGD's and Square's deltas
    feasible, FAB-t's and the preset's magnitudes printed; --run-checks's
    battery must find the chain path deterministic and its outputs
    logits; then --eval-files. Returns {run: launches}."""
    from certifyingfacerecognition_torch.eval import chunk_runner

    os.environ["CFR_TAIL"] = "bc"
    predict = chunk_runner.make_predict_fn("insightface", 1024,
                                           torch.bfloat16)
    checked = []
    battery = chunk_runner.run_all_checks

    def run_all_checks(*args, **kwargs):
        checked.append(battery(*args, **kwargs))
        return checked[-1]

    chunk_runner.run_all_checks = run_all_checks
    launches_by_run = {}
    try:
        for attack, extra in AA_RUNS:
            name = attack + "".join(extra)
            out = "aa_" + name.replace("--", "_")
            bc.reset_launches()
            t0 = time.time()
            main(["--output-dir", out, "--data-dir", data, "--attack-type",
                  attack, "--face-recog-method", "insightface", "--dtype",
                  "bf16", "--resolution", "1024",
                  "--chunks", str(ATTACK_IDS // AA_IDS), "--num-chunk", "0",
                  "--gen-weights", "random:0", "--frm-weights", frm_path,
                  "--scale-factor", str(ATTACK_SCALE), "--seed", "0",
                  "--load-embs", *AA_FLAGS, *extra])
            torch.cuda.synchronize()
            secs = time.time() - t0
            launches = chain_launches(bc)
            launches_by_run[name] = launches
            if not all(launches.values()):
                raise AssertionError(f"{name}: chain kernels not launched: "
                                     f"{launches}")
            stats, mags = check_attack_artifacts(
                os.path.join("exp_results", out), w, region, predict, params,
                chunk=f"0of{ATTACK_IDS // AA_IDS}", n_ids=AA_IDS,
                batch=AA_IDS, bounded=attack in AA_BOUNDED)
            log(f"attack {name} 1024^2 bf16 chain tail, {AA_IDS} identities "
                f"at batch {AA_IDS}: {secs:.1f} s for the whole run "
                f"[{gpu}]; {stats}; launches {launches}; every success "
                f"re-verified" + (", feasible" if attack in AA_BOUNDED
                                  else "") +
                f"; squared Sigma-norms of the saved deltas "
                f"{np.round(mags, 4).tolist()}")
    finally:
        chunk_runner.run_all_checks = battery
    log(f"attack --run-checks battery: {checked}")
    if len(checked) != 1 or checked[0]["randomized"] or \
            checked[0]["prob_output"]:
        raise AssertionError(f"--run-checks: {checked}")
    main(["--output-dir", "aa_autoattack", "--eval-files", "--scale-factor",
          str(ATTACK_SCALE)])
    results = open(os.path.join("exp_results", "aa_autoattack",
                                "results.txt")).read().split("\n")
    log(f"attack autoattack --eval-files results.txt: {results}")
    assert [r.split(":")[0] for r in results[:4]] == \
        ["successes", "instances", "rate", "avg_mag"], results
    assert results[1] == f"instances:{AA_IDS}", results
    return launches_by_run


def attack_grad_check(bc, params, w, b=4, draws=3):
    """Gradients with respect to the deltas at B = b, 1024^2, three ways:
    bf16 through the chain tail (all four chain counters must rise), plain
    bf16, and f32; for ``draws`` initial deltas of PGD at the attribute
    budgets (scale factor 1). Two losses: the attack loss (xent over the
    gallery distances, through the generator and ArcFace) and the image
    loss sum(img^2) (through the generator alone, as
    tests/test_tail_bc_integration.py holds the JAX package's tail). For
    each, the chain tail's error against f32 (mean |err| over mean |f32
    gradient|, averaged over the draws) must be no worse than 1.5x the
    plain bf16 path's plus 0.02. Through 50 bf16 ArcFace layers the attack
    loss's gradient is noisy on both bf16 paths (0.3-0.9 of its size on
    random weights, measured on an H100); the image loss's is not (about
    0.06), so there a tail whose gradient were lost (error ~1) also fails
    its check."""
    from certifyingfacerecognition_torch.attacks.losses import compute_loss
    from certifyingfacerecognition_torch.eval.chunk_runner import \
        make_dists_fn
    from certifyingfacerecognition_torch.models.stylegan import \
        synthesize_from_w
    from certifyingfacerecognition_torch.ops import geometry as G

    region = G.get_all_matrices(device="cuda")
    lats = torch.as_tensor(w[:b], device="cuda")
    labels = torch.arange(b, device="cuda")
    deltas = [G.init_deltas(torch.Generator().manual_seed(2 + i), b,
                            region.red_ellipse) for i in range(draws)]
    losses = {
        "attack loss": lambda fn, dt, x: compute_loss(
            fn(params, x), labels, loss_type="xent"),
        "image loss": lambda fn, dt, x: (synthesize_from_w(
            params["gen"], x, resolution=1024, dtype=dt).float() ** 2).sum()}
    grads = {name: {} for name in losses}
    for tag, dtype, tail in (("bc", torch.bfloat16, "bc"),
                             ("plain16", torch.bfloat16, ""),
                             ("f32", torch.float32, "")):
        os.environ["CFR_TAIL"] = tail
        fn = make_dists_fn("insightface", 1024, dtype)
        for name, loss_fn in losses.items():
            bc.reset_launches()
            grads[name][tag] = []
            for d0 in deltas:
                d = d0.clone().requires_grad_()
                loss = loss_fn(fn, dtype, lats + d @ region.dirs.t())
                grads[name][tag].append(torch.autograd.grad(loss, d)[0])
            torch.cuda.synchronize()
            if tag == "bc":
                chain = {k: bc.LAUNCHES[k] for k in CHAIN}
                log(f"{name} gradient through the chain tail: launches "
                    f"{chain}")
                if not all(chain.values()):
                    raise AssertionError(f"chain kernels not launched: "
                                         f"{chain}")
    for name, by_tag in grads.items():
        err = {t: float(np.mean([
            ((g - g32).abs().mean() / g32.abs().mean()).item()
            for g, g32 in zip(by_tag[t], by_tag["f32"])]))
            for t in ("bc", "plain16")}
        log(f"check {name} gradient d/ddeltas 1024^2 B={b} vs f32, mean of "
            f"{draws} draws: chain tail {err['bc']:.4f}, plain bf16 "
            f"{err['plain16']:.4f} (mean|err| / mean|f32|)")
        for g in sum(by_tag.values(), []):
            assert torch.isfinite(g).all() and g.abs().max() > 0
        assert err["bc"] <= 1.5 * err["plain16"] + 0.02


def pgd_step_times(params, w, region, gpu, reps=3):
    """Seconds per PGD iteration at batch ATTACK_IDS, 1024^2, bf16:
    forward (distances + loss) and backward (the gradient with respect to
    the deltas, with the rematerialised forward), through the chain tail
    and on plain ops; median of ``reps`` after one warm-up, each half
    ended by a device synchronisation."""
    from certifyingfacerecognition_torch.attacks.losses import compute_loss
    from certifyingfacerecognition_torch.eval.chunk_runner import \
        make_dists_fn
    from certifyingfacerecognition_torch.ops import geometry as G

    lats = torch.as_tensor(w, device="cuda")
    labels = torch.arange(len(w), device="cuda")
    deltas = G.init_deltas(torch.Generator().manual_seed(3), len(w),
                           region.red_ellipse)
    out = {}
    for tag, tail in (("bc", "bc"), ("plain16", "")):
        os.environ["CFR_TAIL"] = tail
        fn = make_dists_fn("insightface", 1024, torch.bfloat16)
        torch.cuda.reset_peak_memory_stats()
        fwd, bwd = [], []
        for _ in range(reps + 1):
            d = deltas.clone().requires_grad_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = compute_loss(fn(params, lats + d @ region.dirs.t()),
                                labels, loss_type="xent")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            torch.autograd.grad(loss, d)
            torch.cuda.synchronize()
            fwd.append(t1 - t0)
            bwd.append(time.perf_counter() - t1)
        f, b_ = float(np.median(fwd[1:])), float(np.median(bwd[1:]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[tag] = (f, b_)
        log(f"PGD iteration 1024^2 bf16 batch {len(w)} "
            f"({'chain tail' if tag == 'bc' else 'plain ops'}): forward "
            f"{f:.3f} s + backward {b_:.3f} s = {f + b_:.3f} s per "
            f"iteration, peak memory {peak:.1f} GiB [{gpu}]")
    return out


GEN_IDS = 32             # StyleGAN identities of phase 10 (two batches)
PGGAN_IDS = 16


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit RGB, non-interlaced PNG's pixels [H, W, 3], read with zlib
    and struct alone; every chunk's CRC is checked, and every row must use
    filter type 0 (what the port writes)."""
    import struct
    import zlib

    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, idat, shape = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert zlib.crc32(tag + body) & 0xFFFFFFFF == crc, f"CRC of {tag}"
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                                body)
            assert (depth, ctype, interlace) == (8, 2, 0), body
            shape = (h, w)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    h, w = shape
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(
        h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all(), "a row with a filter other than 0"
    return rows[:, 1:].reshape(h, w, 3)


def generate_run(main, out, argv, tail):
    """One cfr-generate-data-torch run (its log echoed): (seconds, seconds
    spent writing PNGs, {PNG name: the uint8 array the CLI encoded}), the
    PNGs decoded and held equal to those arrays."""
    from certifyingfacerecognition_torch.cli import generate_data

    os.environ["CFR_TAIL"] = tail
    written, write_png, png_secs = {}, generate_data.write_png, [0.0]

    def record(path, rgb):
        written[os.path.basename(path)] = rgb.copy()
        t = time.perf_counter()
        write_png(path, rgb)
        png_secs[0] += time.perf_counter() - t

    generate_data.write_png = record
    buf = io.StringIO()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            main(argv + ["-o", out])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        generate_data.write_png = write_png
    for line in buf.getvalue().splitlines():
        log(line)
    names = sorted(os.listdir(os.path.join(out, "ims")))
    assert names == sorted(written), (names, sorted(written))
    for name in names:
        with open(os.path.join(out, "ims", name), "rb") as f:
            got = decode_png(f.read())
        if not np.array_equal(got, written[name]):
            raise AssertionError(f"{out}/ims/{name} does not decode to the "
                                 f"array the CLI encoded")
    return secs, png_secs[0], written


def check_generation(main, bc, root, gpu):
    """Phase 10, identity generation at 1024^2 (cfr-generate-data-torch).
    StyleGAN-FFHQ (random:0, full widths), Z space, 32 identities at batch
    16, three times: bf16 with CFR_TAIL=bc (all four chain counters must
    rise), plain bf16 (none may) and fp32. The codes (z, w, wp: mapping
    and truncation run in f32) must be equal across the three; the chain
    path's images must be within phase 5's rule of fp32's (mean |err| at
    most 1.5x plain bf16's + 1e-4, on the written pixels / 255). Then
    PGGAN-CelebA-HQ (random weights, 512 -> 16 channels), 16 identities
    at batch 16, bf16 and fp32: its bf16 image (pggan.apply on the runs'
    z) within 0.05 of the f32 image's scale at 32^2 (the JAX package's
    bound, at its test's size) and within 0.02 of it on average at
    1024^2. Every PNG is decoded with zlib here and must equal the array
    the CLI encoded. Images/s of each run, whole run (weights, codes,
    synthesis, PNG encoding)."""
    from certifyingfacerecognition_torch.models import pggan
    from certifyingfacerecognition_torch.utils import weights as W

    sg = ["-m", "stylegan_ffhq", "-s", "z", "-n", str(GEN_IDS),
          "--batch-size", "16", "--weights", "random:0"]
    runs, codes = {}, {}
    for tag, dtype, tail in (("bc", "bf16", "bc"), ("plain16", "bf16", ""),
                             ("f32", "fp32", "")):
        out = os.path.join(root, f"gen_{tag}")
        bc.reset_launches()
        secs, png_secs, written = generate_run(
            main, out, sg + ["--dtype", dtype], tail)
        launches = chain_launches(bc)
        if (tag == "bc") != all(launches.values()) or \
                (tag != "bc" and any(bc.LAUNCHES.values())):
            raise AssertionError(f"StyleGAN generation ({tag}): launches "
                                 f"{dict(bc.LAUNCHES)}")
        runs[tag] = np.stack([written[k] for k in sorted(written)])
        codes[tag] = {k: np.load(os.path.join(out, f"{k}.npy"))
                      for k in ("z", "w", "wp")}
        log(f"generate StyleGAN 1024^2 {dtype} "
            f"{'chain tail' if tag == 'bc' else 'plain ops'}: {GEN_IDS} "
            f"images in {secs:.3f} s = {GEN_IDS / secs:.2f} images/s (whole "
            f"run, {png_secs:.3f} s of it writing PNGs); launches "
            f"{launches} [{gpu}]")
    os.environ["CFR_TAIL"] = "bc"
    assert runs["f32"].shape == (GEN_IDS, 1024, 1024, 3)
    assert codes["f32"]["wp"].shape == (GEN_IDS, 18, 512)
    for tag in ("bc", "plain16"):
        for k, v in codes["f32"].items():
            if not np.array_equal(codes[tag][k], v):
                raise AssertionError(f"{k}.npy of the {tag} run differs "
                                     f"from the fp32 run's")
    err = {t: float(np.abs(runs[t].astype(np.float64) - runs["f32"]).mean()
                    / 255) for t in ("bc", "plain16")}
    log(f"check generated 1024^2 images vs fp32: mean|err| chain tail "
        f"{err['bc']:.3e}, plain bf16 {err['plain16']:.3e}")
    if err["bc"] > 1.5 * err["plain16"] + 1e-4:
        raise AssertionError("the chain tail's generated images are further "
                             "from fp32 than phase 5's rule allows")
    del runs

    pg = ["-m", "pggan_celebahq", "-n", str(PGGAN_IDS), "--batch-size",
          str(PGGAN_IDS)]
    for dtype in ("bf16", "fp32"):
        out = os.path.join(root, f"gen_pggan_{dtype}")
        bc.reset_launches()
        secs, png_secs, written = generate_run(
            main, out, pg + ["--dtype", dtype], "")
        assert not any(bc.LAUNCHES.values()), bc.LAUNCHES
        assert len(written) == PGGAN_IDS
        log(f"generate PGGAN 1024^2 {dtype}: {PGGAN_IDS} images in "
            f"{secs:.3f} s = {PGGAN_IDS / secs:.2f} images/s (whole run, "
            f"{png_secs:.3f} s of it writing PNGs) [{gpu}]")
    z = np.load(os.path.join(root, "gen_pggan_fp32", "z.npy"))
    assert np.array_equal(z, np.load(os.path.join(root, "gen_pggan_bf16",
                                                  "z.npy")))
    # bf16 against f32 on the runs' z, at the JAX test's 32^2 with its
    # bound on the largest error, and at 1024^2 on the mean error: the JAX
    # package's own bf16 path drifts further from its f32 path as the
    # resolution grows (tests/test_torch_pggan.py holds the port's drift
    # to the JAX package's), so the 32^2 bound does not carry to 1024^2
    for res, bound in ((32, ("max", 0.05)), (1024, ("mean", 0.02))):
        params = W.load_generator_params("random", "pggan_celebahq",
                                         resolution=res)
        img = {}
        with torch.inference_mode():
            for dtype in (torch.bfloat16, torch.float32):
                img[dtype] = pggan.apply(
                    params, torch.as_tensor(z, device="cuda"),
                    resolution=res, dtype=dtype).float().cpu().numpy()
        assert img[torch.float32].shape == (PGGAN_IDS, 3, res, res)
        assert np.isfinite(img[torch.bfloat16]).all()
        scale = max(1.0, float(np.abs(img[torch.float32]).max()))
        diff = np.abs(img[torch.bfloat16] - img[torch.float32]) / scale
        stat, limit = bound
        got = float(getattr(diff, stat)())
        log(f"check PGGAN {res}^2 bf16 vs f32 (scale max(1, max|f32|) = "
            f"{scale:.3f}): max|err| / scale {diff.max():.3e}, mean "
            f"{diff.mean():.3e}; bound on the {stat}: {limit}")
        if got > limit:
            raise AssertionError(f"PGGAN's bf16 image at {res}^2: {stat} "
                                 f"|err| / scale {got:.3e} > {limit}")
        del params, img, diff
    torch.cuda.empty_cache()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def check_mesh(main, bc, root, frm_path, rows_bc, gpu):
    """Phase 11, cfr-certify-torch --mesh on the card, in this process as a
    one-rank group (torchrun's variables: MASTER_ADDR=localhost, a free
    MASTER_PORT, WORLD_SIZE=1, RANK=0), with phase 5's data and settings
    and CFR_TAIL=bc: --mesh, --mesh --mesh-id 1, and --mesh --adaptive
    guaranteed --adaptive-engine device at phase 5b's settings (one batch
    per checkpoint, slack 0). The backend must be NCCL, each TSV must
    equal phase 5's bc.tsv in idx..radius, all four chain counters must
    rise. One rank on one card runs every collective of the mesh path
    (the counts' all-reduce, the gallery's all-gather), each over a group
    of one; several ranks need several GPUs, since NCCL does not put two
    ranks on one GPU (the multi-rank runs are the CPU tests' gloo runs)."""
    out = os.path.join(root, "mesh.tsv")
    per_id = {}
    env = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
    try:
        for name, extra in (
                ("--mesh", ["--mesh"]),
                ("--mesh --mesh-id 1", ["--mesh", "--mesh-id", "1"]),
                ("--mesh, adaptive guaranteed, device engine",
                 ["--mesh", "--adaptive", "guaranteed", "--adaptive-engine",
                  "device", "--adaptive-chunk-batches", "1",
                  "--adaptive-slack", "0"])):
            os.environ.update(MASTER_ADDR="localhost",
                              MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                              RANK="0")
            bc.reset_launches()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rows, _, secs, _ = certify_run(main, root, frm_path, out,
                                               "bc", extra=extra)
            for line in buf.getvalue().splitlines():
                log(line)
            launches = chain_launches(bc)
            log(f"certify {name}: {rows}; launches {launches}")
            if "distributed: rank 0 of 1, backend nccl" not in buf.getvalue():
                raise AssertionError(f"certify {name} did not run on a "
                                     f"one-rank NCCL group")
            if tsv_columns(rows) != tsv_columns(rows_bc):
                raise AssertionError(f"certify {name} differs from phase "
                                     f"5's rows")
            if not all(launches.values()):
                raise AssertionError(f"chain kernels not launched: "
                                     f"{launches}")
            per_id[name] = secs / len(rows)
    finally:
        for k in env:
            os.environ.pop(k, None)
    log("certify --mesh (one NCCL rank) 1024^2 bf16 chain tail, s/identity: "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_id.items()) + f" [{gpu}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    t_start = time.time()
    from certifyingfacerecognition_torch.cli import (certify, generate_data,
                                                     main_attack)
    from certifyingfacerecognition_torch.eval.chunk_runner import \
        make_predict_fn
    from certifyingfacerecognition_torch.ops import geometry as G
    from certifyingfacerecognition_torch.ops import kernels
    from certifyingfacerecognition_torch.ops import synthesis_tail_bc as bc
    from certifyingfacerecognition_torch.utils import weights as W

    gpu = gpu_line()
    log(gpu)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    os.environ["CFR_TAIL"] = "bc"
    # plain versions in f32 compare against full-precision convolutions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    check_build(kernels)

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = check_kernels(bc, gen)
    check_chain(bc, gen)
    timing = time_kernels(bc, gen, gpu)

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        w, frm_path, pipes, gen_params, embs = make_data_dir(root, {})
        check_outputs(pipes, gen_params, w, embs)
        del pipes
        torch.cuda.empty_cache()

        bc.reset_launches()
        rows, samples, secs, _ = certify_run(
            certify.main, root, frm_path, os.path.join(root, "bc.tsv"), "bc")
        launches = dict(bc.LAUNCHES)
        log(f"certify path (CFR_TAIL=bc): {rows}")
        log(f"certify path launches: {launches}")
        missing = [k for k in CHAIN if launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the certify "
                                 f"path: {missing}")
        log(f"certify path bf16 chain tail: {samples} samples in "
            f"{secs:.3f} s = {samples / secs:.1f} samples/s [{gpu}]")

        bc.reset_launches()
        rows_p, samples_p, secs_p, _ = certify_run(
            certify.main, root, frm_path, os.path.join(root, "plain.tsv"), "")
        assert all(v == 0 for v in bc.LAUNCHES.values()), bc.LAUNCHES
        log(f"certify path (plain bf16): {rows_p}")
        log(f"certify path bf16 plain ops: {samples_p} samples in "
            f"{secs_p:.3f} s = {samples_p / secs_p:.1f} samples/s [{gpu}]")
        torch.cuda.empty_cache()

        check_adaptive(certify.main, bc, root, frm_path, rows, gpu)
        torch.cuda.empty_cache()
        check_cascade(certify.main, bc, root, frm_path, w, rows,
                      samples / secs, gpu)
        torch.cuda.empty_cache()

        facenet_launches = check_facenet(certify.main, bc, root, w,
                                         gen_params, gpu)
        log(f"FaceNet certify path launches: {facenet_launches}")
        torch.cuda.empty_cache()

        standalone = check_standalone_tail(bc, gen)
        torch.cuda.empty_cache()

        # the attack path; the CLI writes exp_results/ under its cwd
        data = os.path.join(root, "attack")
        w_atk = attack_data_dir(data)
        frm_atk = os.path.join(root, "arcface_r50_scaled.npz")
        log(f"attack FRM: phase-5 ArcFace weights, feature affine scaled by "
            f"{scaled_frm(frm_path, w_atk, frm_atk):.3e} to a mean "
            f"embedding norm of 25")
        os.chdir(root)
        try:
            bc.reset_launches()
            secs_bc = attack_run(main_attack.main, data, frm_atk, "atk_bc",
                                 "bc", load_embs=False)
            attack_launches = dict(bc.LAUNCHES)
            log(f"attack path (CFR_TAIL=bc) launches: {attack_launches}, "
                f"{secs_bc:.1f} s for the whole run [{gpu}]")
            if not all(attack_launches[k] for k in CHAIN) or \
                    any(attack_launches[k] for k in STANDALONE):
                raise AssertionError("the attack path must launch every "
                                     "chain kernel and no standalone one")
            bc.reset_launches()
            secs_plain = attack_run(main_attack.main, data, frm_atk,
                                    "atk_plain", "", load_embs=True)
            assert all(v == 0 for v in bc.LAUNCHES.values()), bc.LAUNCHES
            log(f"attack path (plain bf16): {secs_plain:.1f} s for the "
                f"whole run [{gpu}]")
            os.environ["CFR_TAIL"] = "bc"
            main_attack.main(["--output-dir", "atk_bc", "--eval-files",
                              "--scale-factor", str(ATTACK_SCALE)])
            results = open(os.path.join("exp_results", "atk_bc",
                                        "results.txt")).read().split("\n")
            log(f"attack --eval-files results.txt: {results}")
            assert [r.split(":")[0] for r in results[:4]] == \
                ["successes", "instances", "rate", "avg_mag"], results
            assert results[1] == f"instances:{ATTACK_IDS}", results

            region = G.get_all_matrices(scale_factor=ATTACK_SCALE,
                                        device="cuda")
            params = {"gen": W.load_generator_params("random:0",
                                                     resolution=1024),
                      "frm": W.load_frm_params(frm_atk),
                      "gallery": torch.as_tensor(W.load_embeddings(
                          os.path.join(data, "embs_insightface.npz")),
                          device="cuda")}
            for out, tail in (("atk_bc", "bc"), ("atk_plain", "")):
                os.environ["CFR_TAIL"] = tail
                stats, _ = check_attack_artifacts(
                    os.path.join("exp_results", out), w_atk, region,
                    make_predict_fn("insightface", 1024, torch.bfloat16),
                    params)
                log(f"attack artifacts {out}: {stats}, every success "
                    f"feasible and re-verified")
            torch.cuda.empty_cache()
            check_autoattack(main_attack.main, bc, data, frm_atk, w_atk,
                             region, params, gpu)
        finally:
            os.chdir(cwd)
        torch.cuda.empty_cache()
        attack_grad_check(bc, params, w_atk)
        torch.cuda.empty_cache()
        pgd_step_times(params, w_atk, region, gpu)
        del params
        torch.cuda.empty_cache()

        check_generation(generate_data.main, bc, root, gpu)
        check_mesh(certify.main, bc, root, frm_path, rows, gpu)

    records = []
    for name in CHAIN + STANDALONE:
        t = timing[name]
        records.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": (attack_launches if name in CHAIN
                         else standalone)[name],
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
