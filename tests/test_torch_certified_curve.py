"""The port's tools/certified_curve.py against the JAX package's:
certified_accuracy on random arrays (exact), and both CLIs on the same two
TSVs write byte-identical CSVs, and --png without matplotlib exits before
it writes anything."""

import os.path as osp
import sys

import numpy as np
import pytest

from certifyingfacerecognition_tpu.tools import certified_curve as jcc
from certifyingfacerecognition_torch.tools import certified_curve as tcc


def _write_tsv(path, correct, radius):
    with open(path, "w") as fh:
        fh.write("idx\tlabel\tpredict\tcorrect\tgap\tradius\ttime\n")
        for i, (c, r) in enumerate(zip(correct, radius)):
            fh.write(f"{i}\t{i}\t{i if c else -1}\t{int(c)}\t1.0\t{r}\t"
                     "0:00:01\n")


def test_certified_accuracy_matches_jax():
    rng = np.random.default_rng(0)
    correct = rng.random(200) < 0.7
    radius = np.round(rng.random(200) * 2, 3)
    radii = tcc.parse_radii("0:2:0.01")
    np.testing.assert_array_equal(radii, jcc.parse_radii("0:2:0.01"))
    np.testing.assert_array_equal(
        tcc.certified_accuracy(correct, radius, radii),
        jcc.certified_accuracy(correct, radius, radii))


def test_cli_csv_identical_to_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    tsvs = []
    for name in ("a.tsv", "b.tsv"):
        path = str(tmp_path / name)
        _write_tsv(path, rng.random(9) < 0.6, np.round(rng.random(9), 4))
        tsvs.append(path)
    want, got = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    jcc.main(tsvs + ["-o", want, "--radii", "0:1:0.05"])
    tcc.main(tsvs + ["-o", got, "--radii", "0:1:0.05"])
    assert open(got, "rb").read() == open(want, "rb").read()
    assert len(open(got).read().splitlines()) == 22
    # --png without matplotlib (an import of it fails) exits before it
    # writes anything
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = str(tmp_path / "png.csv")
    with pytest.raises(SystemExit, match="matplotlib"):
        tcc.main(tsvs + ["-o", out, "--png", str(tmp_path / "c.png")])
    assert not osp.exists(out)
