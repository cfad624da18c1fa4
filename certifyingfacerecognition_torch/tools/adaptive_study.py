"""Adaptive early-stopping certification study (port of
certifyingfacerecognition_tpu/tools/adaptive_study.py).

Certifies the same identities three ways (fixed N, --adaptive guaranteed
and --adaptive sequential), identity i drawing its noise from
``identity_generator(7, i)`` in every mode, and reports the deployment
metric (identities per hour), the samples per identity and the decisions'
agreement with the fixed-N run. Guaranteed mode's agreement is 1.0 (a
theorem: it draws the fixed run's noise and stops only once the fixed
run's decision is settled); sequential mode's measures the statistical
trade for these weights and sigma. One JSON line per mode. The first
identity (or group) of each mode is left out of the clock: on the card it
is the kernels' first use and cuDNN's autotuning.

Weights: StyleGAN random:0 realistic, ArcFace iresnet-50 He-scaled;
bf16, through the chain kernels when CFR_TAIL=bc.

Usage: python -m certifyingfacerecognition_torch.tools.adaptive_study

Env knobs: AS_IDS (identities, default 200), AS_GALLERY (1000), AS_N
(10000), AS_N0 (100), AS_SIGMA (3.0), AS_ALPHA (0.001), AS_BATCH (128),
AS_CHUNK (8 batches per checkpoint), AS_SLACK (0.1), AS_GAP_TARGET
(optional float), AS_RESOLUTION (1024), AS_MODES (comma list out of
fixed,guaranteed,sequential; the agreement is reported only when fixed is
in the list), AS_ENGINE (host | device, smoothing/adaptive_device.py;
fixed mode ignores it), AS_GROUP (identities per dispatch, device engine
only: Smooth.certify_adaptive_many).

AS_GALLERY_PAD=M (default off): pad the AS_GALLERY-row gallery to M rows
with far-away rows drawn on the device (torch.Generator seeded 99): the
decisions are untouched, the distance matmul, top-k and class counts run
at the padded size.

AS_AB="FLAG=v1,v2": run the whole study once per value of an environment
flag in one process, a fresh pipeline per value (CFR_TAIL and
CFR_TAIL_MIN_RES are read at call time), each JSON line tagged with the
flag. ``--device`` (default cuda; cpu runs the plain versions).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def population(n_gallery: int, resolution: int, device,
               spectral_gamma: float = 0.0):
    """(gen_params, frm_params, w_all [n_gallery, 512] numpy, dirs [5, 512]
    numpy) of the study tools: StyleGAN random:0 realistic weights,
    He-scaled ArcFace iresnet-50 (random:0 ArcFace weights give NaN
    embeddings), W-space identities from the mapping network over
    unit-sphere z drawn from np.random.default_rng(0), and five orthonormal
    attribute directions from the same generator."""
    from ..models import iresnet, stylegan

    gen_params = stylegan.random_params(resolution, seed=0, realistic=True,
                                        device=device,
                                        spectral_gamma=spectral_gamma)
    frm_params = iresnet.convert_torch_state_dict(
        iresnet.random_torch_style_state_dict("iresnet50", seed=0,
                                              realistic=True), device=device)
    rng = np.random.default_rng(0)
    z = rng.standard_normal((n_gallery, 512)).astype(np.float32)
    z = z / np.linalg.norm(z, axis=1, keepdims=True) * np.sqrt(512)
    with torch.inference_mode():
        w_all = stylegan.mapping_apply(
            gen_params, torch.as_tensor(z, device=device)).cpu().numpy()
    dirs = np.linalg.qr(rng.standard_normal((512, 5)))[0][:, :5].T.astype(
        np.float32)
    return gen_params, frm_params, w_all, dirs


def study_pipeline(gen_params, frm_params, dirs, resolution: int, w_all,
                   batch: int, device):
    """The bf16 FacePipeline at ``resolution`` with its gallery, the
    embeddings of ``w_all`` in batches of ``batch``, set as a device f32
    tensor (FacePipeline moves a gallery only when it is constructed)."""
    from ..models.pipeline import FacePipeline
    from ..utils.profiling import device_sync

    pipe = FacePipeline(gen_params, frm_params, dirs=dirs,
                        frs_method="insightface", resolution=resolution,
                        dtype=torch.bfloat16, device=device)
    gallery = pipe.lat2embs(w_all, chunk=batch)
    pipe.gallery = torch.as_tensor(gallery, dtype=torch.float32,
                                   device=pipe.device)
    device_sync(pipe.gallery)
    return pipe


def run_study(tag=None, device="cuda"):
    from ..smoothing.certificate import L2Certificate
    from ..smoothing.smooth import Smooth, identity_generator
    from ..utils.device import device_name, resolve_device
    from ..utils.profiling import device_sync

    n_ids = int(os.environ.get("AS_IDS", "200"))
    n_gallery = int(os.environ.get("AS_GALLERY", "1000"))
    N = int(os.environ.get("AS_N", "10000"))
    N0 = int(os.environ.get("AS_N0", "100"))
    sigma_v = float(os.environ.get("AS_SIGMA", "3.0"))
    alpha = float(os.environ.get("AS_ALPHA", "0.001"))
    batch = int(os.environ.get("AS_BATCH", "128"))
    chunk = int(os.environ.get("AS_CHUNK", "8"))
    slack = float(os.environ.get("AS_SLACK", "0.1"))
    gap_target = os.environ.get("AS_GAP_TARGET")
    gap_target = float(gap_target) if gap_target else None
    resolution = int(os.environ.get("AS_RESOLUTION", "1024"))
    engine = os.environ.get("AS_ENGINE", "host")
    group = int(os.environ.get("AS_GROUP", "1"))
    if group > 1 and engine != "device":
        raise ValueError("AS_GROUP > 1 requires AS_ENGINE=device")

    dev = resolve_device(device)
    gen_params, frm_params, w_all, dirs = population(n_gallery, resolution,
                                                     dev)
    pipe = study_pipeline(gen_params, frm_params, dirs, resolution, w_all,
                          batch, dev)
    n_classes = n_gallery
    pad_to = int(os.environ.get("AS_GALLERY_PAD", "0"))
    if pad_to > n_gallery:
        # Deployment-scale head: pad rows ~10 embedding-shell radii from
        # every real row, so the argmin (and with it every decision) is
        # untouched while the distance matmul, top-k and per-class counts
        # run at the padded size.
        real = pipe.gallery
        r = float(torch.linalg.vector_norm(real, dim=1).mean())
        gen = torch.Generator(device=dev).manual_seed(99)
        pad = torch.randn((pad_to - n_gallery, 512), generator=gen,
                          device=dev)
        pad = pad / torch.linalg.vector_norm(pad, dim=1, keepdim=True) * r
        pad = pad + 10.0 * r / np.sqrt(512.0)
        pipe.gallery = torch.cat([real, pad])
        device_sync(pipe.gallery)
        n_classes = pad_to
    predict_fn, params = pipe.predict_fn_with_params()
    smoothed = Smooth(predict_fn, n_classes, np.full((5,), sigma_v,
                                                     np.float32),
                      L2Certificate(), noise_dim=5, batch_size=batch,
                      params=params, device=dev)
    x = np.zeros((5,), np.float32)

    def clock():
        device_sync(pipe.gallery)
        return time.time()

    def certify_mode(mode):
        if mode != "fixed" and group > 1:
            return certify_mode_grouped(mode)
        rows, t_start, samples = [], None, 0
        for i in range(n_ids):
            gen = identity_generator(7, i, dev)
            if mode == "fixed":
                pred, gap = smoothed.certify(w_all[i], x, i, N0, N, alpha,
                                             gen)
                ran = pred == i or pred == -1 or gap > 0.0
                used = N0 + (N if ran else 0)
            else:
                pred, gap, used = smoothed.certify_adaptive(
                    w_all[i], x, i, N0, N, alpha, gen, mode=mode,
                    chunk_batches=chunk, slack=slack, gap_target=gap_target,
                    engine=engine)
            if t_start is None:    # the first identity is not timed
                t_start = clock()
            else:
                samples += used
            rows.append((int(pred), float(gap)))
        return rows, clock() - t_start, samples

    def certify_mode_grouped(mode):
        # AS_GROUP identities per dispatch; the first group is not timed
        # (n_timed below is n_ids - group).
        rows, t_start, samples = [], None, 0
        for g0 in range(0, n_ids, group):
            ids = list(range(g0, min(g0 + group, n_ids)))
            out = smoothed.certify_adaptive_many(
                [w_all[i] for i in ids], [x] * len(ids), ids, N0, N, alpha,
                [identity_generator(7, i, dev) for i in ids], mode=mode,
                chunk_batches=chunk, slack=slack, gap_target=gap_target,
                pad_to=group)
            if t_start is None:
                t_start = clock()
            else:
                samples += sum(used for _, _, used in out)
            rows.extend((int(p), float(g)) for p, g, _ in out)
        return rows, clock() - t_start, samples

    modes = [m.strip() for m in os.environ.get(
        "AS_MODES", "fixed,guaranteed,sequential").split(",") if m.strip()]
    kind = device_name(dev)
    results = {}
    for mode in modes:
        rows, elapsed, samples = certify_mode(mode)
        results[mode] = rows
        n_timed = n_ids - (group if mode != "fixed" and group > 1 else 1)
        out = {
            "mode": mode, "ids": n_ids, "N": N, "N0": N0, "sigma": sigma_v,
            "gallery": n_classes,
            "batch": batch, "chunk_batches": chunk, "slack": slack,
            "gap_target": gap_target,
            "engine": engine if mode != "fixed" else None,
            "group": group if mode != "fixed" else None,
            "samples_per_id": round(samples / n_timed, 1),
            "certify_s_per_id": round(elapsed / n_timed, 3),
            "ids_per_hour": round(3600.0 * n_timed / elapsed, 1),
            "certified_correct": sum(1 for i, (p, g) in enumerate(rows)
                                     if p == i),
            "abstain": sum(1 for p, _ in rows if p == -1),
        }
        if mode != "fixed" and "fixed" in results:
            base = results["fixed"]
            out["decision_agreement_vs_fixed"] = round(float(np.mean(
                [p == bp for (p, _), (bp, _) in zip(rows, base)])), 4)
            both = [(g, bg) for (p, g), (bp, bg) in zip(rows, base)
                    if g > 0 and bg > 0]
            out["mean_gap_ratio_vs_fixed"] = (
                round(float(np.mean([g / bg for g, bg in both])), 4)
                if both else None)
        if tag:
            out["env"] = tag
        out["device"] = kind
        print(json.dumps(out), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"], help="cuda needs a CUDA GPU")
    args = p.parse_args(argv)
    ab = os.environ.get("AS_AB")
    if not ab:
        run_study(device=args.device)
        return
    flag, _, values = ab.partition("=")
    if not values:
        raise SystemExit(f"AS_AB needs FLAG=v1,v2 (got {ab!r})")
    for val in values.split(","):
        if val == "":
            os.environ.pop(flag, None)
        else:
            os.environ[flag] = val
        run_study(tag={flag: val or None}, device=args.device)


if __name__ == "__main__":
    main()
