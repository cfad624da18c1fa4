"""AutoAttack-style orchestration for the Lsigma2 semantic-ellipsoid norm
(port of certifyingfacerecognition_tpu/attacks/autoattack.py).

The classifier is logits(deltas [B, k]) = -distances(lat + deltas @
dirs^T), the clean point is the zero delta, and per-attack robust-flag
bookkeeping keeps the first successful adversary of each sample.
'square' is the ellipsoid-native score-based attack (attacks/square.py).
Untargeted FAB needs one gradient per gallery class and raises; the
'plus' preset runs without it.

As in the JAX package, every attack of a preset runs over the full batch
and the samples already broken are masked out of the bookkeeping: the
results equal those of attacking the still-robust subset, with no gather.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import torch

from ..ops import geometry as G
from .apgd import apgd_attack, apgd_targeted_attack
from .fab import fab_targeted
from .pgd import check_deltas
from .square import square_attack

SUPPORTED = ("fab-t", "apgd-ce", "apgd-dlr", "apgd-t", "square")

# set_version presets for the Lsigma2 norm: standard = 4 attacks; 'rand'
# the two APGD variants (every model here is deterministic, so EOT is not
# replicated); 'plus' the reference's 6-attack list minus untargeted FAB.
VERSION_PRESETS = {
    "standard": ("apgd-ce", "apgd-t", "fab-t", "square"),
    "rand": ("apgd-ce", "apgd-dlr"),
    "plus": ("apgd-ce", "apgd-dlr", "square", "apgd-t", "fab-t"),
}

# Per-version restart counts of the untargeted APGDs and of FAB-t
# (apgd-t keeps 1 restart in every version).
VERSION_RESTARTS = {"standard": (1, 1), "rand": (1, 1), "plus": (5, 5)}


class AttackResult(NamedTuple):
    deltas: torch.Tensor      # [B, k]
    success: torch.Tensor     # [B] bool
    magnitudes: torch.Tensor  # [B] squared Sigma-norms


def _injected(name: str, draws) -> dict:
    """The keyword argument that hands attack ``name`` its injected draws
    (none when ``draws`` is None)."""
    if draws is None:
        return {}
    return {"draws" if name == "square" else "init": draws}


def run_attack(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    labels: torch.Tensor,
    gen: torch.Generator,
    region: G.RegionMatrices,
    attack_type: str,
    *,
    iters: int = 5,
    restarts: int = 5,
    n_target_classes: int = 5,
    apgd_use_cli_iters: bool = False,
    draws=None,
) -> AttackResult:
    """One attack in delta space. ``draws``, when given, is the attack's
    injected random draws (see each attack's ``init`` / ``draws``)."""
    inj = _injected(attack_type, draws)
    if attack_type == "fab-t":
        r = fab_targeted(logits_fn, labels, gen, region, n_iter=iters,
                         n_restarts=restarts,
                         n_target_classes=n_target_classes, **inj)
        return AttackResult(*r)
    if attack_type in ("apgd-ce", "apgd-dlr"):
        # The reference wires only the targeted APGD to the CLI; the
        # untargeted one keeps its internal 100 iterations x 1 restart
        # unless apgd_use_cli_iters.
        n_iter, n_restarts = (iters, restarts) if apgd_use_cli_iters \
            else (100, 1)
        if not apgd_use_cli_iters and (iters, restarts) != (100, 1):
            warnings.warn(
                f"{attack_type}: --iters/--restarts ({iters}/{restarts}) are "
                "IGNORED for reference parity: the reference only wires "
                "apgd_targeted to the CLI, so untargeted APGD runs its "
                "internal defaults 100 iters x 1 restart. Pass "
                "--apgd-use-cli-iters to honor the CLI values instead.",
                stacklevel=2)
        r = apgd_attack(logits_fn, labels, gen, region,
                        loss=attack_type.split("-")[1], n_iter=n_iter,
                        n_restarts=n_restarts, **inj)
        return AttackResult(*r)
    if attack_type == "apgd-t":
        r = apgd_targeted_attack(logits_fn, labels, gen, region,
                                 n_iter=iters, n_restarts=restarts,
                                 n_target_classes=n_target_classes, **inj)
        return AttackResult(*r)
    if attack_type == "square":
        r = square_attack(logits_fn, labels, gen, region,
                          n_iter=max(iters, 1) * 20, n_restarts=restarts,
                          **inj)
        return AttackResult(*r)
    if attack_type == "fab":
        raise NotImplementedError(
            "untargeted FAB requires one VJP per gallery class and is "
            "intractable at gallery scale (reference gen_utils.py:283); "
            "use fab-t")
    raise ValueError(f"unknown attack {attack_type}")


class StandardEvalResult(NamedTuple):
    deltas: torch.Tensor       # [B, k] first successful adversary (or 0)
    y_adv: torch.Tensor        # [B] prediction at the recorded delta
    success: torch.Tensor      # [B] bool: sample broken by SOME attack
    magnitudes: torch.Tensor   # [B] squared Sigma-norm of recorded deltas
    robust_accuracy: dict      # {'clean': acc, '<attack>': acc, ...}


def _dispatch_preset(name: str, logits_fn, labels, gen, region,
                     n_target: int, square_queries: int,
                     preset_iters: int = 100, apgd_restarts: int = 1,
                     fab_restarts: int = 1, draws=None):
    """One attack with its set_version parameters; preset_iters scales the
    per-attack iteration budget down from 100 for smoke runs and tests."""
    inj = _injected(name, None if draws is None else draws.get(name))
    if name in ("apgd-ce", "apgd-dlr"):
        return apgd_attack(logits_fn, labels, gen, region,
                           loss=name.split("-")[1], n_iter=preset_iters,
                           n_restarts=apgd_restarts, **inj)
    if name == "apgd-t":
        return apgd_targeted_attack(logits_fn, labels, gen, region,
                                    n_iter=preset_iters, n_restarts=1,
                                    n_target_classes=n_target, **inj)
    if name == "fab-t":
        return fab_targeted(logits_fn, labels, gen, region,
                            n_iter=preset_iters, n_restarts=fab_restarts,
                            n_target_classes=n_target, **inj)
    if name == "square":
        return square_attack(logits_fn, labels, gen, region,
                             n_iter=square_queries, n_restarts=1, **inj)
    raise ValueError(f"unsupported attack {name!r}")


@torch.no_grad()
def run_standard_evaluation(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    labels: torch.Tensor,
    gen: torch.Generator,
    region: G.RegionMatrices,
    *,
    attacks_to_run: Optional[Sequence[str]] = None,
    version: str = "standard",
    n_delta_dims: int = 5,
    square_queries: int = 5000,
    preset_iters: int = 100,
    logger=None,
    run_checks: bool = False,
    draws: Optional[Dict[str, object]] = None,
) -> StandardEvalResult:
    """Sequential multi-attack evaluation with robust-flag accumulation: a
    clean pass, then each attack in order, demoting the samples it breaks;
    the robust accuracy after each attack is reported and the first
    successful adversary of each sample is kept. ``draws`` {attack name:
    draws}, when given, hands each attack its random draws."""

    def _log(msg):
        if logger is not None:
            logger.info(msg)

    if attacks_to_run is None:
        if version not in VERSION_PRESETS:
            raise ValueError(
                f"unknown AutoAttack version {version!r}; known: "
                f"{sorted(VERSION_PRESETS)} (our 'plus' omits untargeted "
                "FAB, intractable at gallery scale)")
        attacks_to_run = VERSION_PRESETS[version]
    for a in attacks_to_run:
        if a not in SUPPORTED:
            raise ValueError(f"unsupported attack {a!r} (supported: "
                             f"{SUPPORTED})")
    apgd_restarts, fab_restarts = VERSION_RESTARTS.get(version, (1, 1))

    B = labels.shape[0]
    zeros = torch.zeros((B, n_delta_dims), device=labels.device)
    if run_checks:
        from . import checks
        if version != "rand":
            checks.check_randomized(logits_fn, zeros, labels, logger=logger)
        checks.check_range_output(logits_fn, zeros, logger=logger)

    clean_logits = logits_fn(zeros)
    # the standard preset's 9 target classes, clipped to the gallery size
    n_target = min(9, clean_logits.shape[1] - 1)
    clean_pred = clean_logits.argmax(dim=1)
    robust = clean_pred == labels
    y_adv = clean_pred
    deltas = zeros
    acc = {"clean": robust.float().mean().item()}
    _log(f"initial accuracy: {acc['clean']:.2%}")

    start = time.time()
    for name in attacks_to_run:
        if not bool(robust.any()):
            break
        adv_deltas = _dispatch_preset(name, logits_fn, labels, gen, region,
                                      n_target, square_queries, preset_iters,
                                      apgd_restarts, fab_restarts,
                                      draws).deltas
        pred = logits_fn(adv_deltas).argmax(dim=1)
        newly = robust & (pred != labels)
        deltas = torch.where(newly[:, None], adv_deltas, deltas)
        y_adv = torch.where(newly, pred, y_adv)
        robust = robust & ~newly
        acc[name] = robust.float().mean().item()
        _log(f"robust accuracy after {name.upper()}: {acc[name]:.2%} "
             f"(total time {time.time() - start:.1f} s)")

    if run_checks:
        from . import checks
        checks.check_square_sr(acc, logger=logger)

    magnitudes = G.sq_distance_diag(region.red_ellipse_diag, deltas)
    _log(f"max Lsigma2 perturbation: "
         f"{torch.sqrt(magnitudes.max()).item():.5f}")
    _log(f"robust accuracy: {min(acc.values()):.2%}")
    return StandardEvalResult(deltas, y_adv, ~robust, magnitudes, acc)


def _split(gen: torch.Generator) -> torch.Generator:
    """A new generator on ``gen``'s device, seeded from ``gen``'s stream
    (the JAX package splits its key)."""
    seed = torch.randint(2 ** 62, (), generator=gen, device=gen.device)
    return torch.Generator(device=gen.device).manual_seed(int(seed))


def run_standard_evaluation_individual(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    labels: torch.Tensor,
    gen: torch.Generator,
    region: G.RegionMatrices,
    *,
    attacks_to_run: Optional[Sequence[str]] = None,
    version: str = "standard",
    logger=None,
    **kwargs,
) -> Dict[str, StandardEvalResult]:
    """Per-attack (not sequential) evaluation: each attack runs on the
    full clean batch on its own, with a generator of its own drawn from
    ``gen``, and reports its own robust accuracy. ``kwargs`` go to
    run_standard_evaluation. Returns {attack: StandardEvalResult}."""
    if attacks_to_run is None:
        if version not in VERSION_PRESETS:
            raise ValueError(f"unknown AutoAttack version {version!r}")
        attacks_to_run = VERSION_PRESETS[version]
    out = {}
    for name in attacks_to_run:
        t0 = time.time()
        out[name] = run_standard_evaluation(
            logits_fn, labels, _split(gen), region, attacks_to_run=(name,),
            version=version, **kwargs)
        if logger is not None:
            # with clean accuracy 0 the attack never runs: its robust
            # accuracy is the clean one (0 %), not 100 %
            acc = out[name].robust_accuracy.get(
                name, out[name].robust_accuracy.get("clean", 1.0))
            logger.info(f"robust accuracy by {name.upper()} \t {acc:.2%} "
                        f"\t (time attack: {time.time() - t0:.1f} s)")
    return out


def _logits_of(dists_fn: Callable, lat_codes: torch.Tensor,
               region: G.RegionMatrices) -> Callable:
    """logits(deltas) = -dists(lat + deltas @ dirs^T), the product in
    full f32."""
    dirs_t = region.dirs.t()
    return lambda deltas: -dists_fn(lat_codes + G.matmul_f32(deltas, dirs_t))


def make_standard_evaluation(
    dists_fn: Callable[[dict, torch.Tensor], torch.Tensor],
    region: G.RegionMatrices,
    *,
    version: str = "standard",
    n_delta_dims: int = 5,
    square_queries: int = 5000,
    preset_iters: int = 100,
    logger=None,
    run_checks: bool = False,
) -> Callable:
    """run(params, lats, labels, gen) -> StandardEvalResult, the preset
    ``version`` over one batch; dists_fn(params, w) gives the gallery
    distances."""
    if version not in VERSION_PRESETS:
        raise ValueError(
            f"unknown AutoAttack version {version!r}; known: "
            f"{sorted(VERSION_PRESETS)}")

    def run(params, lats, labels, gen):
        return run_standard_evaluation(
            _logits_of(lambda w: dists_fn(params, w), lats, region), labels,
            gen, region, version=version, n_delta_dims=n_delta_dims,
            square_queries=square_queries, preset_iters=preset_iters,
            logger=logger, run_checks=run_checks)

    return run


@torch.no_grad()
def find_adversaries_autoattack(
    dists_fn: Callable[[torch.Tensor], torch.Tensor],
    lat_codes: torch.Tensor,
    labels: torch.Tensor,
    gen: torch.Generator,
    region: G.RegionMatrices,
    attack_type: str,
    *,
    iters: int = 5,
    restarts: int = 5,
    n_target_classes: int = 5,
    apgd_use_cli_iters: bool = False,
    draws=None,
) -> AttackResult:
    """Run one AutoAttack-family attack, re-verify the predictions at the
    final deltas and report their Sigma-magnitudes (feasibility is checked
    on the host by eval_chunk)."""
    logits_fn = _logits_of(dists_fn, lat_codes, region)
    res = run_attack(logits_fn, labels, gen, region, attack_type,
                     iters=iters, restarts=restarts,
                     n_target_classes=n_target_classes,
                     apgd_use_cli_iters=apgd_use_cli_iters, draws=draws)
    success = logits_fn(res.deltas).argmax(dim=1) != labels
    return AttackResult(res.deltas, success,
                        check_deltas(res.deltas, region, lin_comb=True))
