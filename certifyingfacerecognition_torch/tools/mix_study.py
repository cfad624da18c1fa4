"""Predicted against measured identities per hour on a population with a
spread of pA (port of certifyingfacerecognition_tpu/tools/mix_study.py).

  1. Time model, calibrated in the run: a fixed-N pass over the study
     population gives the device cost per sample ``t_sample``; a grouped
     sequential run at sigma = 0.1 (pA ~ 1, where every identity stops at
     the first checkpoint) gives the overhead per identity
     ``ovh = s_per_id - samples_per_id * t_sample``.
  2. pA per identity: the fixed pass records each identity's class
     histogram, p_hat = n_a / N; MS_SIGMA chooses the spread.
  3. Predicted samples from the engine's own rules: per identity the
     stopping rule is simulated on the host (``_simulate_samples``) with
     the integer threshold tables the device engine runs
     (adaptive_device.build_thresholds): selection as an N0-draw
     multinomial, then per checkpoint n_a += Binomial(valid_k, p_hat)
     against (t_emit, t_abst).
  4. Measured: the grouped device engine (Smooth.certify_adaptive_many)
     certifies the same population with the same noise; predicted and
     measured mean samples and identities per hour are printed side by
     side with their relative errors.

Identity i draws its noise from ``identity_generator(7, i)``: the fixed
pass draws its N0 and then its N samples from that one generator, the
sequential run the same samples in the same order up to its stop, so
``decision_agreement_vs_fixed`` compares like with like. The first
identity of the fixed pass and the first group of each grouped run are
left out of the clock (on the card: the kernels' first use, cuDNN's
autotuning).

bf16, through the chain kernels when CFR_TAIL=bc.

Usage: python -m certifyingfacerecognition_torch.tools.mix_study

Env knobs: MS_IDS (64), MS_GALLERY (1000), MS_N (10000), MS_N0 (100),
MS_ALPHA (0.001), MS_SIGMA (4.0), MS_BATCH (128), MS_CHUNK (1),
MS_SLACK (1.0), MS_GROUP (8), MS_RESOLUTION (1024), MS_SIMS (400
stopping-rule simulations per identity), MS_OVERHEAD_IDS (16, the
sigma = 0.1 calibration population), MS_PROBE (when set: only the p_hat
histogram, from MS_PROBE samples per identity, for choosing sigma).
``--device`` (default cuda; cpu runs the plain versions).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _simulate_samples(class_probs: np.ndarray, label: int, n0: int, n: int,
                      tab, valid, chunk_batches: int, sims: int, rng
                      ) -> np.ndarray:
    """Monte-Carlo the device engine's stopping rule: the total samples of
    each of ``sims`` simulations.

    ``class_probs`` is the identity's class histogram from the fixed pass
    (counts / N). Selection is simulated as the engine runs it (argmax of
    an N0-draw multinomial; ties go to the lowest class index, as
    np.argmax does), and the MC phase adds Bernoulli(p_label) successes
    per checkpoint against the engine's integer threshold tables.
    """
    p_hat = float(class_probs[label])
    n_chunks = len(tab.m_k)
    out = np.empty((sims,), np.int64)
    valid = np.asarray(valid, np.int64).reshape(n_chunks, chunk_batches)
    chunk_sizes = valid.sum(axis=1)
    for s in range(sims):
        counts0 = rng.multinomial(n0, class_probs)
        if int(np.argmax(counts0)) != label:   # selection fails: N0 only
            out[s] = n0
            continue
        n_a, m, used = 0, 0, n0
        for k in range(n_chunks):
            n_a += rng.binomial(chunk_sizes[k], p_hat)
            m += chunk_sizes[k]
            used = n0 + m
            if n_a <= tab.t_abst[k] or n_a >= tab.t_emit[k]:
                break
        out[s] = used
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"], help="cuda needs a CUDA GPU")
    args = p.parse_args(argv)

    from ..smoothing import adaptive_device as AD
    from ..smoothing.certificate import L2Certificate
    from ..smoothing.smooth import Smooth, identity_generator
    from ..utils.device import device_name, resolve_device
    from ..utils.profiling import device_sync
    from ..utils.stats import clopper_pearson_lower
    from .adaptive_study import population, study_pipeline

    n_ids = int(os.environ.get("MS_IDS", "64"))
    n_gallery = int(os.environ.get("MS_GALLERY", "1000"))
    N = int(os.environ.get("MS_N", "10000"))
    N0 = int(os.environ.get("MS_N0", "100"))
    alpha = float(os.environ.get("MS_ALPHA", "0.001"))
    sigma_v = float(os.environ.get("MS_SIGMA", "4.0"))
    batch = int(os.environ.get("MS_BATCH", "128"))
    chunk = int(os.environ.get("MS_CHUNK", "1"))
    slack = float(os.environ.get("MS_SLACK", "1.0"))
    group = int(os.environ.get("MS_GROUP", "8"))
    resolution = int(os.environ.get("MS_RESOLUTION", "1024"))
    sims = int(os.environ.get("MS_SIMS", "400"))
    ovh_ids = int(os.environ.get("MS_OVERHEAD_IDS", "16"))
    probe = int(os.environ.get("MS_PROBE", "0"))

    # The population of tools/adaptive_study (realistic proxy weights).
    dev = resolve_device(args.device)
    kind = device_name(dev)
    gen_params, frm_params, w_all, dirs = population(n_gallery, resolution,
                                                     dev)
    pipe = study_pipeline(gen_params, frm_params, dirs, resolution, w_all,
                          batch, dev)
    predict_fn, params = pipe.predict_fn_with_params()

    def make_smooth(sig):
        return Smooth(predict_fn, n_gallery, np.full((5,), sig, np.float32),
                      L2Certificate(), noise_dim=5, batch_size=batch,
                      params=params, device=dev)

    def clock():
        device_sync(pipe.gallery)
        return time.time()

    x = np.zeros((5,), np.float32)

    if probe:
        # Cheap sigma selection: p_hat from MS_PROBE samples per identity.
        sm = make_smooth(sigma_v)
        p_hats = []
        for i in range(n_ids):
            counts = sm._sample_noise(w_all[i], x, probe,
                                      identity_generator(7, i, dev))
            p_hats.append(float(counts[i]) / probe)
        hist = np.histogram(p_hats, bins=[0, .45, .55, .75, .9, .99, 1.001])
        print(json.dumps({
            "probe": probe, "sigma": sigma_v, "ids": n_ids,
            "p_hat_mean": round(float(np.mean(p_hats)), 4),
            "bins": [0, .45, .55, .75, .9, .99, 1.0],
            "counts": hist[0].tolist(),
            "p_hats": [round(v, 4) for v in p_hats],
            "device": kind}), flush=True)
        return

    # ---- 1a. overhead calibration: sigma = 0.1 grouped sequential run ----
    sm01 = make_smooth(0.1)
    ovh_rows = []
    t0 = None
    for g0 in range(0, 2 * ovh_ids, group):
        ids = list(range(g0, g0 + group))
        out = sm01.certify_adaptive_many(
            [w_all[i] for i in ids], [x] * group, ids, N0, N, alpha,
            [identity_generator(7, i, dev) for i in ids], mode="sequential",
            chunk_batches=chunk, slack=slack, pad_to=group)
        if t0 is None:   # the first group is not timed
            t0 = clock()
        else:
            ovh_rows.extend(out)
        if len(ovh_rows) >= ovh_ids:
            break
    dt01 = clock() - t0
    s01_per_id = dt01 / len(ovh_rows)
    samples01 = float(np.mean([u for _, _, u in ovh_rows]))

    # ---- 1b/2. fixed pass at MS_SIGMA: t_sample and p_hat per identity ----
    sm = make_smooth(sigma_v)
    fixed, p_hats, class_hists = [], [], []
    t0, total_samples = None, 0
    for i in range(n_ids):
        gen = identity_generator(7, i, dev)
        counts0 = sm._sample_noise(w_all[i], x, N0, gen)
        c_hat = int(counts0.argmax())
        counts = sm._sample_noise(w_all[i], x, N, gen)
        if t0 is None:
            t0 = clock()   # the timed window starts at identity 1
        else:
            total_samples += N0 + N
        n_a = int(counts[i])
        p_hats.append(n_a / N)
        class_hists.append(np.asarray(counts, np.float64) / counts.sum())
        # certify()'s decision on the same counts
        if c_hat != i:
            fixed.append((c_hat, 0.0))
        else:
            p_a_bar = clopper_pearson_lower(int(counts[c_hat]), N, alpha)
            fixed.append((Smooth.ABSTAIN, 0.0) if p_a_bar < 0.5
                         else (c_hat, sm.certificate.compute_gap(p_a_bar)))
    dt_fixed = clock() - t0
    t_sample = dt_fixed / total_samples
    ovh = max(0.0, s01_per_id - samples01 * t_sample)

    # ---- 3. samples per identity predicted from the engine's tables ----
    valid = AD._loop_shapes(sm, N0, N, chunk)[5]
    tab = AD.build_thresholds("sequential", N, valid, chunk, alpha,
                              sm.certificate, slack, None)
    sim_rng = np.random.default_rng(42)
    pred_samples = np.array([
        float(np.mean(_simulate_samples(class_hists[i], i, N0, N, tab,
                                        valid, chunk, sims, sim_rng)))
        for i in range(n_ids)])
    pred_mean = float(pred_samples.mean())
    pred_s_per_id = ovh + pred_mean * t_sample
    pred_ids_per_hour = 3600.0 / pred_s_per_id

    # ---- 4. measured: the grouped device engine on the same noise ----
    seq, t0 = [], None
    for g0 in range(0, n_ids, group):
        ids = list(range(g0, min(g0 + group, n_ids)))
        out = sm.certify_adaptive_many(
            [w_all[i] for i in ids], [x] * len(ids), ids, N0, N, alpha,
            [identity_generator(7, i, dev) for i in ids], mode="sequential",
            chunk_batches=chunk, slack=slack, pad_to=group)
        if t0 is None:
            t0 = clock()
        else:
            seq.extend(out)
    dt_seq = clock() - t0
    n_timed = n_ids - group
    meas_samples = float(np.mean([u for _, _, u in seq]))
    meas_s_per_id = dt_seq / n_timed
    meas_ids_per_hour = 3600.0 * n_timed / dt_seq

    bins = [0, .45, .55, .75, .9, .99, 1.001]
    hist = np.histogram(p_hats, bins=bins)[0].tolist()
    # seq holds the rows of identities group..n_ids-1 (the first group is
    # left out of both the clock and the rows).
    agree = float(np.mean([seq[j][0] == fixed[group + j][0]
                           for j in range(len(seq))]))

    print(json.dumps({
        "sigma": sigma_v, "ids": n_ids, "N": N, "N0": N0, "alpha": alpha,
        "batch": batch, "chunk_batches": chunk, "slack": slack,
        "group": group,
        "p_hat_bins": bins[:-1] + [1.0], "p_hat_hist": hist,
        "p_hat_mean": round(float(np.mean(p_hats)), 4),
        "t_sample_ms": round(t_sample * 1e3, 4),
        "overhead_s_per_id": round(ovh, 4),
        "sigma01_s_per_id": round(s01_per_id, 4),
        "sigma01_samples_per_id": round(samples01, 1),
        "pred_mean_samples": round(pred_mean, 1),
        "meas_mean_samples": round(meas_samples, 1),
        "samples_rel_err": round(pred_mean / meas_samples - 1.0, 4),
        "pred_s_per_id": round(pred_s_per_id, 4),
        "meas_s_per_id": round(meas_s_per_id, 4),
        "pred_ids_per_hour": round(pred_ids_per_hour, 1),
        "meas_ids_per_hour": round(meas_ids_per_hour, 1),
        "ids_per_hour_rel_err": round(
            pred_ids_per_hour / meas_ids_per_hour - 1.0, 4),
        "decision_agreement_vs_fixed": round(agree, 4),
        "device": kind,
    }), flush=True)


if __name__ == "__main__":
    main()
