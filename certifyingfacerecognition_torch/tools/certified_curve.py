"""Certified-accuracy-vs-radius curves from certification TSVs (a copy
of certifyingfacerecognition_tpu/tools/certified_curve.py).

The reference pipeline emits per-identity TSV rows (certify.py:138-157)
and leaves the standard randomized-smoothing evaluation figure (certified
accuracy at radius r = fraction of rows with correct==1 and radius >= r,
Cohen et al.'19 fig. 1) to manual post-processing. This tool computes it
from one or more TSVs (e.g. per-sigma runs), writes a CSV, and optionally
a PNG (--png needs matplotlib; without it the tool exits before it
writes anything).

Usage:
    python -m certifyingfacerecognition_torch.tools.certified_curve \
        certs/iso_s05.tsv certs/iso_s10.tsv -o curve.csv [--png curve.png]
        [--radii 0:2:0.01]
"""

from __future__ import annotations

import argparse
import csv
import os.path as osp
from typing import List, Tuple

import numpy as np


def read_tsv(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (correct [N] bool, radius [N] float). Abstentions and
    mispredictions count as radius 0 / not certified (they appear in the
    TSV with correct=0; radius is ignored for them)."""
    correct, radius = [], []
    with open(path) as fh:
        reader = csv.DictReader(fh, delimiter="\t")
        for row in reader:
            correct.append(int(row["correct"]) == 1)
            radius.append(float(row["radius"]))
    return np.asarray(correct, bool), np.asarray(radius, np.float64)


def certified_accuracy(correct: np.ndarray, radius: np.ndarray,
                       radii: np.ndarray) -> np.ndarray:
    """certified_acc[r] = mean(correct & (radius >= r))."""
    cert_r = np.where(correct, radius, -np.inf)
    return (cert_r[None, :] >= radii[:, None]).mean(axis=1)


def parse_radii(spec: str) -> np.ndarray:
    lo, hi, step = (float(x) for x in spec.split(":"))
    return np.arange(lo, hi + step / 2, step)


def main(argv: List[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("tsvs", nargs="+", help="certification TSV files")
    ap.add_argument("-o", "--outfile", required=True, help="output CSV")
    ap.add_argument("--radii", default="0:2:0.01",
                    help="lo:hi:step grid of radii")
    ap.add_argument("--png", default=None,
                    help="also render a PNG (requires matplotlib)")
    args = ap.parse_args(argv)
    if args.png:
        try:
            import matplotlib
        except ImportError:
            raise SystemExit("--png needs matplotlib, which is not "
                             "installed; run without --png for the CSV")
        matplotlib.use("Agg")

    radii = parse_radii(args.radii)
    curves = {}
    for path in args.tsvs:
        correct, radius = read_tsv(path)
        curves[osp.basename(path)] = certified_accuracy(
            correct, radius, radii)

    with open(args.outfile, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["radius"] + list(curves))
        for i, r in enumerate(radii):
            w.writerow([f"{r:.6g}"] + [f"{c[i]:.6g}"
                                       for c in curves.values()])
    print(f"Wrote {args.outfile} ({len(radii)} radii x {len(curves)} runs)")

    if args.png:
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(5, 3.5), dpi=150)
        for name, c in curves.items():
            ax.plot(radii, c, label=name)
        ax.set_xlabel("radius")
        ax.set_ylabel("certified accuracy")
        ax.set_ylim(0, 1)
        ax.legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(args.png)
        print(f"Wrote {args.png}")


if __name__ == "__main__":
    main()
