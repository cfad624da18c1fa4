"""Timing harness for the synthesis tail's chain kernels (port of
certifyingfacerecognition_tpu/tools/tail_kernel_bench.py).

Times each chain-mode layer (ops/synthesis_tail_bc.py: up_fused,
conv_fused, final_stats, final_apply, and tail_chain_bc for the whole
tail) alone with ``utils/profiling.measure`` (CUDA events, best of
``--reps``), on inputs generated on the card, and prints one JSON line
per layer: its time, its bound and their ratio. The bound is the least
time an H100 SXM could take for the layer: the larger of the bytes it
must move (each input read once, each output written once) over the HBM3
rate of 3.35 TB/s and its multiply-adds over the dense bf16 tensor-core
rate of 989 TFLOP/s (67 TFLOP/s of f32 FMA for --dtype fp32):

    python -m certifyingfacerecognition_torch.tools.tail_kernel_bench
    python -m certifyingfacerecognition_torch.tools.tail_kernel_bench \\
        --batch 128 --layers up1024

Layers (B = 128, bf16 by default, the 1024^2 model's channel counts):
    up512        : up layer 256^2 x64 -> 512^2 x32      (up_fused)
    conv512      : conv layer 512^2 x32                 (conv_fused)
    up1024       : up layer 512^2 x32 -> 1024^2 x16     (up_fused)
    rgb1024      : last conv + its instance norm + ToRGB 1024^2 x16
                   (final_stats, then final_apply)
    rgbstats1024 : final_stats alone
    rgbapply1024 : final_apply alone
    chain        : the whole >= 512^2 tail (tail_chain_bc); chainN starts
                   at N^2 (128, 256, 512, 1024)
and, outside the default list, the ladder's wider layers up128 (64^2
x256 -> 128^2 x128), up256 (128^2 x128 -> 256^2 x64), conv128 (128^2
x128) and conv256 (256^2 x64). ``--injit N`` times N launches between
one pair of events and divides by N.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Tuple

import torch

from ..utils.profiling import measure

# Peaks of one H100 SXM (NVIDIA data sheet, dense): HBM3 bytes/s, bf16
# tensor-core FLOP/s and f32 (non-tensor-core) FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

ALL_LAYERS = ("up512", "conv512", "up1024", "rgb1024", "rgbstats1024",
              "rgbapply1024", "chain")
# (output resolution, Ci, Co) of the up layers of the 1024^2 model's tail
# ladder; the conv layer of a block keeps Co
UP_LADDER = {128: (256, 128), 256: (128, 64), 512: (64, 32), 1024: (32, 16)}


CHAIN_KERNELS = ("up_fused", "conv_fused", "final_stats", "final_apply")


def kernel_cost(name: str, h: int, ci: int, co: int, b: int,
                dtype=torch.bfloat16) -> Tuple[int, int, float]:
    """(bytes read, bytes written, FLOPs) of one launch of a tail kernel
    (the four chain kernels, or the standalone passes conv_stats,
    conv_apply, conv_rgb_apply, up_stats, up_apply) at input size h:
    activations, nb and weights in ``dtype`` (bf16 weights packed, f32 ones
    as they are), the input affine (chain kernels only), coefs, ToRGB
    weights and sums in f32; a stats pass writes only its sums. A
    multiply-add is 2 FLOPs (the up layer's transposed conv does 2x2 taps
    per output, the conv 3x3; an RGB pass adds the 1x1 ToRGB)."""
    e = torch.empty((), dtype=dtype).element_size()
    up = name.startswith("up")
    out_hw = (2 * h) ** 2 if up else h * h
    read = (h * h * ci * b * e + (16 if up else 9) * ci * co * e
            + out_hw * co * e + (2 * ci * b * 4 if name in CHAIN_KERNELS
                                 else 0))
    sums = 2 * co * b * 4
    write = {"up_fused": out_hw * co * b * e + sums,
             "conv_fused": out_hw * co * b * e + sums,
             "final_stats": sums, "conv_stats": sums, "up_stats": sums,
             "conv_apply": out_hw * co * b * e,
             "up_apply": out_hw * co * b * e,
             "final_apply": 3 * out_hw * b * e,
             "conv_rgb_apply": 3 * out_hw * b * e}[name]
    flops = 2.0 * out_hw * b * (4 if up else 9) * ci * co
    if name.endswith("apply"):
        read += 2 * co * b * 4                       # the coefs
    if name in ("final_apply", "conv_rgb_apply"):
        read += co * 3 * 4 + 3 * 4
        flops += 2.0 * out_hw * b * co * 3
    return read, write, flops


def _size(name: str, prefix: str) -> int:
    """The resolution N of a case named <prefix>N (default 512 for a bare
    'chain'); raises a ValueError naming the case outside the ladder."""
    h = int(name[len(prefix):] or "512")
    if h not in UP_LADDER:
        raise ValueError(f"{name}: no {h}^2 layer in the 1024^2 model's tail "
                         f"ladder {sorted(UP_LADDER)}")
    return h


def _launches(name: str) -> List[Tuple[str, int, int, int]]:
    """The chain-kernel launches (kernel, h, Ci, Co) of a layer case."""
    if name == "rgb1024":
        return [("final_stats", 1024, 16, 16), ("final_apply", 1024, 16, 16)]
    if name == "rgbstats1024":
        return [("final_stats", 1024, 16, 16)]
    if name == "rgbapply1024":
        return [("final_apply", 1024, 16, 16)]
    if name.startswith("chain"):
        first = _size(name, "chain")
        out = []
        for h2, (ci, co) in sorted(UP_LADDER.items()):
            if h2 < first:
                continue
            out.append(("up_fused", h2 // 2, ci, co))
            out += ([("final_stats", h2, co, co), ("final_apply", h2, co, co)]
                    if h2 == 1024 else [("conv_fused", h2, co, co)])
        return out
    if name.startswith("up"):
        h2 = _size(name, "up")
        return [("up_fused", h2 // 2, *UP_LADDER[h2])]
    if name.startswith("conv") and name != "conv1024":
        h = _size(name, "conv")
        return [("conv_fused", h, UP_LADDER[h][1], UP_LADDER[h][1])]
    raise ValueError(f"unknown layer {name!r}")


def layer_cost(name: str, b: int, dtype=torch.bfloat16) -> Dict[str, float]:
    """Bytes, FLOPs and bound (ms, and what bounds it) of a layer case:
    the sums over its kernel launches."""
    read = write = 0
    flops = 0.0
    for kernel, h, ci, co in _launches(name):
        r, w, f = kernel_cost(kernel, h, ci, co, b, dtype)
        read, write, flops = read + r, write + w, flops + f
    t_bytes = (read + write) / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bytes_read": read, "bytes_written": write, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


class _Rand:
    """Inputs generated on the device from one explicit generator."""

    def __init__(self, device, seed=0):
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, shape, dtype=torch.float32, scale=1.0, shift=0.0):
        x = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=dtype)
        return x if (scale, shift) == (1.0, 0.0) else x * scale + shift


def _block(rnd, ci, co, h2, b, with_rgb):
    """Random chain-block tensors for an up (ci -> co, to h2^2) + conv."""
    blk = {"k4": rnd((4, 4, ci, co), scale=0.1),
           "up_nb": rnd((h2, h2, co), scale=0.1),
           "up_s0p1": rnd((b, co), scale=0.1, shift=1.0),
           "up_s1": rnd((b, co), scale=0.1),
           "k": rnd((3, 3, co, co), scale=0.1),
           "conv_nb": rnd((h2, h2, co), scale=0.1),
           "conv_s0p1": rnd((b, co), scale=0.1, shift=1.0),
           "conv_s1": rnd((b, co), scale=0.1)}
    if with_rgb:
        blk["w_rgb"] = rnd((co, 3), scale=0.3)
        blk["b_rgb"] = rnd((3,), scale=0.1)
    return blk


def build_case(name: str, batch: int, dtype=torch.bfloat16, device="cuda"
               ) -> Tuple[Callable, tuple]:
    """(fn, inputs) of one layer case: fn(*inputs) runs it once through
    the port's kernel entry points (their plain versions on the CPU)."""
    from ..ops import synthesis_tail_bc as bc

    _launches(name)                             # unknown names raise
    rnd = _Rand(device)
    b = batch

    def aff(c):
        return torch.stack([torch.ones((c, b), device=device),
                            torch.zeros((c, b), device=device)])

    if name.startswith("chain"):
        first = int(name[5:] or "512")
        ladder = [(h2, ci, co) for h2, (ci, co) in sorted(UP_LADDER.items())
                  if h2 >= first]
        x = rnd((first // 2, first // 2, ladder[0][1], b), dtype)
        blocks = [_block(rnd, ci, co, h2, b, h2 == 1024)
                  for h2, ci, co in ladder]
        return bc.tail_chain_bc, (x, blocks)
    if name.startswith("rgb"):
        x = rnd((1024, 1024, 16, b), dtype)
        blk = _block(rnd, 32, 16, 1024, b, True)
        if name == "rgb1024":
            return (lambda x, blk: bc.conv_rgb_final(
                x, blk["k"], blk["conv_nb"], aff(16), blk["conv_s0p1"],
                blk["conv_s1"], blk["w_rgb"], blk["b_rgb"], 1e-8)), (x, blk)
        if name == "rgbstats1024":
            return (lambda x, blk: bc.final_stats(
                x, blk["k"], blk["conv_nb"], aff(16))), (x, blk)
        return (lambda x, blk: bc.final_apply(
            x, blk["k"], blk["conv_nb"], aff(16), aff(16), blk["w_rgb"],
            blk["b_rgb"])), (x, blk)
    ((kernel, h, ci, co),) = _launches(name)
    x = rnd((h, h, ci, b), dtype)
    if kernel == "up_fused":
        blk = _block(rnd, ci, co, 2 * h, b, False)
        return (lambda x, blk: bc.up_fused(x, blk["k4"], blk["up_nb"],
                                           aff(ci))), (x, blk)
    blk = _block(rnd, ci, co, h, b, False)
    return (lambda x, blk: bc.conv_fused(x, blk["k"], blk["conv_nb"],
                                         aff(ci))), (x, blk)


def run_case(name: str, batch: int, dtype=torch.bfloat16, device="cuda",
             reps: int = 5, injit: int = 0) -> Dict:
    """One layer's JSON record: its time (ms per launch of the case), its
    bound and their ratio, with the device it ran on."""
    fn, inputs = build_case(name, batch, dtype, device)
    n = max(injit, 1)
    last = []

    def reps_fn(*args):
        for _ in range(n):
            out = fn(*args)
        last[:] = [out]
        return out

    with torch.inference_mode():
        ms = measure(reps_fn, *inputs, reps=reps) * 1e3 / n
        outs = last[0] if isinstance(last[0], tuple) else (last[0],)
        finite = all(bool(torch.isfinite(t).all()) for t in outs)
    cost = layer_cost(name, batch, dtype)
    dev = torch.device(device)
    return {"layer": name, "ms": ms, "bound_ms": cost["bound_ms"],
            "x_bound": ms / cost["bound_ms"], "bound_by": cost["bound_by"],
            "finite": finite, "batch": batch,
            "dtype": str(dtype).replace("torch.", ""),
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--layers", type=str, default="all",
                   help="comma list of " + ",".join(ALL_LAYERS)
                        + ", chainN, up128, up256, conv128, conv256")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--dtype", type=str, default="bf16",
                   choices=["bf16", "fp32"])
    p.add_argument("--injit", type=int, default=0,
                   help="time N launches between one pair of events and "
                        "divide by N")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda needs a CUDA GPU; cpu runs the plain versions")
    args = p.parse_args(argv)

    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    names = (ALL_LAYERS if args.layers == "all"
             else tuple(args.layers.split(",")))
    for name in names:
        print(json.dumps(run_case(name, args.batch, dtype, device, args.reps,
                                  args.injit)), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
