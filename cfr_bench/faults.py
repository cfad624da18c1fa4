"""Faults planted in the timed path, for the tests that see ``correct``
come out false and for the readings of ``cfr_bench.calibrate`` at a
cell's own size. Each takes ``patch(obj, name, value)`` (pytest's
``monkeypatch.setattr``, or ``Patches.set``) and breaks one thing where
it is produced."""

from __future__ import annotations

import torch


class Patches:
    """setattr that remembers, for use outside pytest: ``undo`` restores
    every attribute set."""

    def __init__(self):
        self._old = []

    def set(self, obj, name, value):
        self._old.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._old:
            obj, name, value = self._old.pop()
            setattr(obj, name, value)


def alter_answers(patch):
    """The gallery head answers the row after the one it found."""
    from certifyingfacerecognition_torch.ops import distances as D

    real = D.argmin_dist_refined

    def altered(x, gallery, method="insightface", k=8):
        return (real(x, gallery, method, k) + 1) % gallery.shape[0]
    patch(D, "argmin_dist_refined", altered)


def half_batch(patch):
    """The face-recognition network embeds the first half of each batch
    and hands its rows out twice."""
    from certifyingfacerecognition_torch.models import pipeline as P

    real = P.frm_apply

    def half(frs, params, x, dtype=torch.float32):
        e = real(frs, params, x[: (x.shape[0] + 1) // 2], dtype=dtype)
        return torch.cat([e, e])[: x.shape[0]]
    patch(P, "frm_apply", half)


def still_noise(patch):
    """The smoothing noise left out: every sample is the clean latent."""
    from certifyingfacerecognition_torch.smoothing.certificate import \
        L2Certificate

    patch(L2Certificate, "sample_noise",
          lambda self, gen, shape, sigma: torch.zeros(shape,
                                                      device=gen.device))


def half_counted(patch):
    """Half of each batch left out of the counts."""
    from certifyingfacerecognition_torch.smoothing import smooth

    real = smooth.batch_valid
    patch(smooth, "batch_valid", lambda num, bs: real(num, bs) // 2)


def found_everything(patch):
    """PGD claims an adversary for every identity."""
    from certifyingfacerecognition_torch.attacks import pgd

    real = pgd.find_adversaries_pgd

    def claims(*a, **k):
        res = real(*a, **k)
        return res._replace(found=torch.ones_like(res.found))
    patch(pgd, "find_adversaries_pgd", claims)


def fab_found_everything(patch):
    """FAB-t claims an adversary for every identity."""
    from certifyingfacerecognition_torch.attacks import autoattack

    real = autoattack.find_adversaries_autoattack

    def claims(*a, **k):
        res = real(*a, **k)
        return res._replace(success=torch.ones_like(res.success))
    patch(autoattack, "find_adversaries_autoattack", claims)


def step_unchanged(patch):
    """The PGD step returns the iterate unchanged."""
    from certifyingfacerecognition_torch.attacks import pgd

    patch(pgd._Optimizer, "step", lambda self, params, grads, state: params)


FAULTS = {f.__name__: f for f in (alter_answers, half_batch, still_noise,
                                  half_counted, found_everything,
                                  fab_found_everything, step_unchanged)}
