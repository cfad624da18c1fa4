"""Attack workload runner: per-chunk attack loop and offline aggregation
(port of certifyingfacerecognition_tpu/eval/chunk_runner.py, PGD only).

  * each batch of identities is attacked with its own torch.Generator,
    seeded with the reference's per-batch seed seed + num_chunk *
    chunk_length + batch index;
  * successful adversaries are re-verified from scratch (the deltas are
    re-applied, re-synthesised and re-classified by the exact predictor,
    in attack-sized zero-padded batches); mismatches are demoted with a
    log line;
  * artifacts (results_chunk{K}of{N} logs/npz, 3-panel adversary figures)
    keep the JAX package's formats.
"""

from __future__ import annotations

import os.path as osp
from functools import partial
from time import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..attacks.pgd import assert_deltas_feasible, find_adversaries_pgd
from ..constants import ATTRS
from ..models.pipeline import make_lat2embs
from ..ops import distances as D
from ..ops import geometry as G
from . import artifacts, ranking


def make_dists_fn(frs_method: str, resolution: int, dtype=torch.float32
                  ) -> Callable:
    """dists(params, w [B, 512]) -> [B, N] differentiable gallery
    distances; params = {gen, frm, gallery}.

    With grad enabled the generator + FRM forward is recomputed in the
    backward pass (one checkpoint around the whole function): keeping
    every 1024^2 synthesis activation for the gradient costs
    O(batch x depth) memory; recomputing costs one extra forward."""
    embed = make_lat2embs(frs_method, resolution, dtype=dtype)

    def dists(params, w):
        embs = embed(params["gen"], params["frm"], w).float()
        return D.cdist(embs, params["gallery"], frs_method)

    def remat_dists(params, w):
        if torch.is_grad_enabled():
            return checkpoint(dists, params, w, use_reentrant=False)
        return dists(params, w)

    return remat_dists


def make_predict_fn(frs_method: str, resolution: int, dtype=torch.float32
                    ) -> Callable:
    """Exact identity prediction predict(params, w) -> [B] (the
    exact-refined argmin, forward only)."""
    embed = make_lat2embs(frs_method, resolution, dtype=dtype)

    def predict(params, w):
        with torch.inference_mode():
            embs = embed(params["gen"], params["frm"], w).float()
            return D.argmin_dist_refined(embs, params["gallery"], frs_method)

    return predict


def _make_attack_step(dists_fn: Callable, region: G.RegionMatrices, args
                      ) -> Callable:
    """step(params, lats, labels, gen) -> PGDResult over one batch of
    identities. Only the PGD attack (--attack-type manual) is ported."""
    if args.attack_type != "manual":
        raise SystemExit(f"--attack-type {args.attack_type} is not ported "
                         "to the PyTorch package yet: ROADMAP.md 'Open "
                         "items' 1, item 12 (rest)")

    def step(params, lats, labels, gen):
        return find_adversaries_pgd(
            partial(dists_fn, params), lats, labels, gen, region,
            opt_name=args.optim, lr=args.lr, iters=args.iters,
            momentum=args.momentum, loss_type=args.loss,
            lin_comb=args.lin_comb, random_init=True,
            rand_init_on_surf=not args.not_on_surf, restarts=args.restarts)

    return step


def eval_chunk(params: Dict, lat_codes: np.ndarray, num_chunk: int, args,
               region: G.RegionMatrices, dists_fn: Callable,
               attack_step: Callable, predict_fn: Callable) -> str:
    """Attack one chunk of identities; writes the log and data artifacts
    and returns the log-file path."""
    device = params["gallery"].device
    start_time = time()
    log = args.LOGGER
    log.info(f"Processing chunk {num_chunk} out of {args.chunks}")
    chunk_length = len(lat_codes) / args.chunks
    assert chunk_length == int(chunk_length), \
        "Partition of set should be exact"
    chunk_length = int(chunk_length)
    bs = min(args.batch_size, chunk_length)
    assert chunk_length % bs == 0, \
        f"Batch size MUST divide chunk length: {chunk_length} vs {bs}"

    start = num_chunk * chunk_length
    chunk_lats = np.asarray(lat_codes[start:start + chunk_length], np.float32)

    deltas, successes, magnitudes, all_labels = [], [], [], []
    tot = 0
    for idx in range(0, chunk_length, bs):
        batch = torch.as_tensor(chunk_lats[idx:idx + bs], device=device)
        labels = torch.arange(start + idx, start + idx + batch.shape[0],
                              device=device)
        gen = torch.Generator().manual_seed(
            args.seed + num_chunk * chunk_length + idx // bs)
        res = attack_step(params, batch, labels, gen)
        deltas.append(res.best_deltas.cpu().numpy())
        successes.append(res.found.cpu().numpy())
        magnitudes.append(res.magnitudes.cpu().numpy())
        all_labels.append(labels.cpu().numpy())
        tot += batch.shape[0]
        mags = np.concatenate(magnitudes)
        succ = np.concatenate(successes)
        avg = float(np.sqrt(mags[succ]).mean()) if succ.any() else 0.0
        log.info(f"-> {int(succ.sum())} advs for {tot} IDs "
                 f"-> avg. pert.: {avg:3.4f}")

    deltas = np.concatenate(deltas)
    successes = np.concatenate(successes)
    magnitudes = np.concatenate(magnitudes)
    all_labels = np.concatenate(all_labels)
    log.info(f"Finished chunk computation. Time={time() - start_time:3.2f}s")

    n_succ = int(successes.sum())
    if n_succ:
        assert_deltas_feasible(torch.as_tensor(deltas[successes],
                                               device=device),
                               region, lin_comb=args.lin_comb)

    avg_pert = 0.0
    if n_succ == 0:
        log.info("Didnt find any adversary! =(")
    else:
        succ_idx = np.nonzero(successes)[0]
        pert = deltas[succ_idx]
        if args.lin_comb:
            pert = pert @ region.dirs.cpu().numpy().T
        adv_lats = chunk_lats[succ_idx] + pert.astype(np.float32)
        preds_parts = []
        for s in range(0, len(adv_lats), bs):
            batch_lats = adv_lats[s:s + bs]
            n_valid = len(batch_lats)
            if n_valid < bs:
                batch_lats = np.concatenate(
                    [batch_lats, np.zeros((bs - n_valid, batch_lats.shape[1]),
                                          np.float32)])
            p = predict_fn(params, torch.as_tensor(batch_lats, device=device))
            preds_parts.append(p.cpu().numpy()[:n_valid])
        curr_preds = np.concatenate(preds_parts)
        where_adv = curr_preds != all_labels[succ_idx]
        if not where_adv.all():
            log.info(f"Some ({int((~where_adv).sum())}) supposed "
                     "adversaries were NOT adversaries")
        successes[succ_idx] = where_adv
        n_succ = int(successes.sum())
        if n_succ == 0:
            log.info("Didnt find any adversary! =(")
        else:
            avg_pert = float(np.sqrt(magnitudes[successes]).mean())
            log.info(f"-> Found {n_succ} advs for {tot} IDs "
                     f"-> avg. pert.: {avg_pert:3.4f}")
            _plot_advs(params, chunk_lats, deltas, successes, all_labels,
                       curr_preds[where_adv], lat_codes, region, args)

    results = {
        "successes": n_succ,
        "instances": len(all_labels),
        "avg_mags": avg_pert if n_succ != 0 else 0,
    }
    log_file, _ = artifacts.save_chunk_results(
        results, deltas, successes, magnitudes, num_chunk, args.chunks,
        args.results_dir, args.logs_dir)
    return log_file


def _plot_advs(params, chunk_lats, deltas, successes, all_labels, adv_preds,
               lat_codes, region, args, max_figs: int = 16) -> None:
    """3-panel original | adversary | confused-with figures, written with
    PIL (skipped when PIL is missing)."""
    try:
        from PIL import Image
    except ImportError:
        return
    from ..models import stylegan

    succ_idx = np.nonzero(successes)[0][:max_figs]
    if succ_idx.size == 0:
        return
    adv_preds = adv_preds[:max_figs]
    lats = chunk_lats[succ_idx]
    pert = deltas[succ_idx]
    if args.lin_comb:
        pert = pert @ region.dirs.cpu().numpy().T
    device = params["gallery"].device

    def synth(w, bs=4):
        """[n, H, W, 3] images in [0, 1], in batches of ``bs`` (figures
        only: small batches keep this off the memory peak)."""
        outs = []
        with torch.inference_mode():
            for s in range(0, len(w), bs):
                b = torch.as_tensor(np.asarray(w[s:s + bs], np.float32),
                                    device=device)
                img = stylegan.synthesize_from_w(params["gen"], b,
                                                 resolution=args.resolution)
                outs.append(img.permute(0, 2, 3, 1).float().cpu().numpy())
        return np.concatenate(outs)

    ims = synth(lats)
    adv_ims = synth(lats + pert.astype(np.float32))
    conf_ims = synth(np.asarray(lat_codes)[adv_preds])

    for j, i in enumerate(succ_idx):
        panel = np.concatenate([ims[j], adv_ims[j], conf_ims[j]], axis=1)
        panel = (np.clip(panel, 0, 1) * 255).astype(np.uint8)
        label, pred = int(all_labels[i]), int(adv_preds[j])
        Image.fromarray(panel).save(
            osp.join(args.figs_dir, f"ori_{label}_adv_{pred}.jpg"))


def eval_files(args, epsilons: Optional[np.ndarray] = None) -> None:
    """Aggregate chunk artifacts into results.txt, the attribute ranking
    and the accuracy-vs-budget curve (host only)."""
    log_files, data_files = artifacts.find_chunk_files(args.results_dir,
                                                       args.logs_dir)
    assert log_files, f"no chunk logs found under {args.logs_dir}"
    agg = ranking.aggregate_results(
        [artifacts.parse_chunk_log(f) for f in log_files])
    args.LOGGER.info(
        f"Total. Successes: {agg['successes']} -- "
        f"Instances: {agg['instances']} -- Rate: {agg['rate']:.2f}% -- "
        f"Avg.Mag.: {agg['avg_mag']:.4f}")
    lines = [f"successes:{agg['successes']}",
             f"instances:{agg['instances']}",
             f"rate:{agg['rate']:4.2f}",
             f"avg_mag:{agg['avg_mag']:4.2f}"]

    if data_files:
        all_deltas = np.concatenate(
            [artifacts.load_chunk_data(f)["deltas"] for f in data_files])
        all_mags = np.concatenate(
            [artifacts.load_chunk_data(f)["magnitudes"] for f in data_files])
        # Zero-magnitude "successes" (initially misclassified samples keep
        # the clean delta) carry no attribute signal.
        nz = all_mags > 1e-12
        if not nz.all():
            args.LOGGER.info(f"Dropping {int((~nz).sum())} zero-magnitude "
                             "deltas from the ranking")
        all_deltas, all_mags = all_deltas[nz], all_mags[nz]
        attr_names = [a for a in ATTRS if a not in set(args.attrs2drop)]
        if epsilons is None:
            # red_ellipse_diag = scale_factor / eps^2: the effective
            # semi-axes are eps / sqrt(scale_factor).
            epsilons = np.array([ATTRS[a] for a in attr_names]) \
                / np.sqrt(args.scale_factor)
        _, norm_comps = ranking.delta_components(all_deltas, all_mags,
                                                 epsilons)
        failed, order, pvals = ranking.get_ranking(norm_comps, attr_names)
        if failed:
            args.LOGGER.info("Attribute ranking failed (Friedman test "
                             "not significant)")
            lines.append("importance-order:failed")
        else:
            args.LOGGER.info(f"Importance ranking: {order} (pvals {pvals})")
            lines.append("importance-order:" + ">".join(order))
            lines.append("order-pvals:" +
                         ">".join(f"{p:3.2E}" for p in pvals))
        _plot_acc_vs_budget(all_mags, agg["instances"], args)

    from ..utils.logger import print_to_log

    for line in lines:
        print_to_log(line, args.final_results)


def _plot_acc_vs_budget(magnitudes: np.ndarray, tot_instances: int, args
                        ) -> None:
    """The accuracy-vs-budget curve as a PNG, or as npz when matplotlib is
    missing."""
    lins, acc = ranking.accuracy_vs_budget(magnitudes, tot_instances)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        np.savez(osp.join(args.figs_dir, "acc_vs_pert.npz"),
                 budget=lins, accuracy=acc)
        return
    fig, ax = plt.subplots()
    ax.plot(lins, 100.0 * acc)
    ax.set_xlabel(r"Perturbation budget ($\Sigma$-norm)")
    ax.set_ylabel("Accuracy [%]")
    ax.grid(True, alpha=0.3)
    fig.savefig(osp.join(args.figs_dir, "acc_vs_pert.png"),
                bbox_inches="tight", dpi=120)
    plt.close(fig)
