"""Reduced-resolution certification study (port of
certifyingfacerecognition_tpu/tools/resolution_study.py).

The FRM only sees a 112^2 resize of the synthesized face, so synthesis
at a lower resolution may decide the same. This tool certifies the same
identities at several synthesis resolutions, each with its own gallery
(the embeddings recomputed at that resolution) and the same noise
(identity i draws from ``identity_generator(7, i)`` at every
resolution), and prints one JSON line per resolution (throughput,
decisions), then per reduced resolution its decision agreement with the
native run and the ``--cascade`` blend (cli/certify.py): identities whose
fast prediction matches their label are re-certified at native
resolution. The first identity of each resolution is left out of the
clock (on the card: the kernels' first use, cuDNN's autotuning).

bf16, through the chain kernels when CFR_TAIL=bc: all four at 1024^2;
up_fused, final_stats and final_apply at 512^2.

Usage: python -m certifyingfacerecognition_torch.tools.resolution_study

Env knobs: RS_IDS (identities certified, default 200), RS_GALLERY
(gallery rows, 1000), RS_N (MC samples, 1000), RS_N0 (100), RS_SIGMA
(6.0), RS_ALPHA (0.001), RS_BATCH (128), RS_RESOLUTIONS
("1024,512,256"), RS_SPECTRAL_GAMMA (0 = plain random weights; else the
PSD-shaped proxy weights, calibrated by tools/spectral_study).
``--device`` (default cuda; cpu runs the plain versions).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"], help="cuda needs a CUDA GPU")
    args = p.parse_args(argv)

    from ..smoothing.certificate import L2Certificate
    from ..smoothing.smooth import Smooth, identity_generator
    from ..utils.device import device_name, resolve_device
    from ..utils.profiling import device_sync
    from .adaptive_study import population, study_pipeline

    n_ids = int(os.environ.get("RS_IDS", "200"))
    n_gallery = int(os.environ.get("RS_GALLERY", "1000"))
    N = int(os.environ.get("RS_N", "1000"))
    N0 = int(os.environ.get("RS_N0", "100"))
    # The default sigma is where decisions are not trivial for the
    # realistic random weights (pA ~ 0.5-1.0): far smaller and every
    # identity certifies at every resolution, which makes agreement
    # vacuous.
    sigma_v = float(os.environ.get("RS_SIGMA", "6.0"))
    alpha = float(os.environ.get("RS_ALPHA", "0.001"))
    batch = int(os.environ.get("RS_BATCH", "128"))
    resolutions = [int(r) for r in os.environ.get(
        "RS_RESOLUTIONS", "1024,512,256").split(",")]
    native = max(resolutions)
    spectral_gamma = float(os.environ.get("RS_SPECTRAL_GAMMA", "0"))

    dev = resolve_device(args.device)
    kind = device_name(dev)
    gen_params, frm_params, w_all, dirs = population(
        n_gallery, native, dev, spectral_gamma=spectral_gamma)

    sigma = np.full((5,), sigma_v, np.float32)
    x = np.zeros((5,), np.float32)
    results = {}
    for res in resolutions:
        t0 = time.time()
        pipe = study_pipeline(gen_params, frm_params, dirs, res, w_all,
                              batch, dev)
        embed_t = time.time() - t0

        predict_fn, params = pipe.predict_fn_with_params()
        smoothed = Smooth(predict_fn, n_gallery, sigma, L2Certificate(),
                          noise_dim=5, batch_size=batch, params=params,
                          device=dev)

        rows, t_start, samples = [], None, 0
        for i in range(n_ids):
            pred, gap = smoothed.certify(w_all[i], x, i, N0, N, alpha,
                                         identity_generator(7, i, dev))
            if t_start is None:       # the first identity is not timed
                device_sync(pipe.gallery)
                t_start = time.time()
            else:
                # N0 selection, plus the N-sample estimation unless the
                # selection already mispredicted (Smooth.certify returns
                # (cAHat != label, gap=0) without running it).
                ran_estimation = pred == i or pred == -1 or gap > 0.0
                samples += N0 + (N if ran_estimation else 0)
            rows.append((int(pred), float(gap)))
        device_sync(pipe.gallery)
        n_timed = n_ids - 1
        elapsed = time.time() - t_start
        sps = samples / elapsed
        results[res] = (rows, elapsed, samples)
        print(json.dumps({
            "resolution": res, "spectral_gamma": spectral_gamma,
            "ids": n_ids, "N": N, "N0": N0, "sigma": sigma_v,
            "embed_s": round(embed_t, 1),
            "certify_s_per_id": round(elapsed / n_timed, 3),
            "samples_per_sec": round(sps, 1),
            # identities/hour is the deployment metric and does not track
            # samples/s across resolutions: the per-identity sample count
            # depends on the decision (a selection rejection stops at N0,
            # a certification or abstention runs the full N).
            "ids_per_hour": round(3600.0 * n_timed / elapsed, 1),
            "certified_correct": sum(1 for i, (p, g) in enumerate(rows)
                                     if p == i),
            "abstain": sum(1 for p, _ in rows if p == -1),
            "device": kind,
        }), flush=True)

    base, base_elapsed, base_samples = results[native]
    for res in resolutions:
        if res == native:
            continue
        cur, cur_elapsed, cur_samples = results[res]
        dec_agree = np.mean([
            (p == i and bp == i) or (p != i and bp != i)
            for i, ((p, _), (bp, _)) in enumerate(zip(cur, base))])
        both = [(g, bg) for (p, g), (bp, bg) in zip(cur, base)
                if g > 0 and bg > 0]
        gap_corr = (round(float(np.corrcoef([g for g, _ in both],
                                            [b for _, b in both])[0, 1]), 4)
                    if len(both) > 2 else None)
        print(json.dumps({
            "agreement_vs_native": {"resolution": res,
                                    "decision_agreement": round(
                                        float(dec_agree), 4),
                                    "gap_corr": gap_corr,
                                    "n_both_certified": len(both)},
            "device": kind}), flush=True)

        # The --cascade blend: identities whose fast prediction matches the
        # label are re-certified at native resolution and emit the native
        # row; every other one keeps the fast row. Certified rows agree
        # with the native run by construction; the only deviation is
        # conservative (fast-path rejections the native run certifies),
        # counted as lost. The blended time charges the native re-run per
        # re-certified identity at the measured native cost.
        frac = np.mean([p == i for i, (p, _) in enumerate(cur)])
        blended_elapsed = cur_elapsed + frac * base_elapsed
        blended_samples = cur_samples + frac * base_samples
        lost = sum(1 for i, ((p, _), (bp, bg))
                   in enumerate(zip(cur, base))
                   if p != i and bp == i and bg > 0)
        n_timed = n_ids - 1
        print(json.dumps({
            "cascade": {"resolution": res,
                        "native_recert_fraction": round(float(frac), 4),
                        # Device throughput over both passes: the native
                        # re-run's samples are overhead, not progress, so
                        # judge the cascade by ids_per_hour_*.
                        "blended_samples_per_sec": round(
                            blended_samples / blended_elapsed, 1),
                        "ids_per_hour_blended": round(
                            3600.0 * n_timed / blended_elapsed, 1),
                        "ids_per_hour_native": round(
                            3600.0 * n_timed / base_elapsed, 1),
                        "ids_per_hour_speedup": round(
                            float(base_elapsed / blended_elapsed), 2),
                        "certified_row_agreement": 1.0,
                        "lost_certifications": lost},
            "device": kind}), flush=True)


if __name__ == "__main__":
    main()
