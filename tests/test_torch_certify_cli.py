"""The port's certify CLI against the JAX CLI on one tiny data directory:
32^2, random generator weights, random He-scaled ArcFace weights saved as
.npz (the default random:0 ArcFace weights drive every embedding to NaN,
where the nearest identity is arbitrary), a gallery of four identities
computed by the JAX pipeline, sigma small enough that every noisy sample keeps its label (so
the counts, and hence every decision, do not depend on the two
frameworks' different noise streams). The TSV header and the idx, label,
predict, correct, gap and radius columns must match row for row.

Torch runs one intra-op thread per process: the suite runs in several
pytest-xdist workers that share the machine's cores."""

import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.cli import certify as jcli
from certifyingfacerecognition_tpu.models import iresnet
from certifyingfacerecognition_tpu.models.pipeline import FacePipeline
from certifyingfacerecognition_tpu.ops import geometry as G
from certifyingfacerecognition_tpu.utils import weights as W
from certifyingfacerecognition_torch.cli import certify as tcli

RES = 32
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cert")
    ws = np.random.default_rng(0).standard_normal((4, 512)).astype(
        np.float32)
    np.save(osp.join(d, "w.npy"), ws)
    frm = iresnet.convert_torch_state_dict(
        iresnet.random_torch_style_state_dict("iresnet18", seed=0,
                                              realistic=True), "iresnet18")
    W.save_params(osp.join(d, "frm.npz"), frm)
    pipe = FacePipeline(W.load_generator_params("random", resolution=RES),
                        frm,
                        dirs=jnp.asarray(G.get_all_matrices().dirs.T),
                        resolution=RES)
    np.savez(osp.join(d, "embs_insightface.npz"),
             embs=np.asarray(pipe.lat2embs(jnp.asarray(ws))))
    return str(d)


def _args(data_dir, out, *extra):
    return ["--face-recog-model", "insightface", "--outfile", out,
            "--sigma", "0.001", "--data-dir", data_dir, "--resolution",
            str(RES), "--frm-weights", osp.join(data_dir, "frm.npz"), "--N0", "8", "--N", "16", "--batch-sz", "8", *extra]


def _rows(path):
    lines = open(path).read().strip().split("\n")
    return lines[0], [line.split("\t")[:6] for line in lines[1:]]


def _compare_clis(data_dir, tmp_path, n_max):
    """The JAX CLI with --max n_max against the port's, run as --max
    n_max - 1 then --resume --max n_max (which appends only the missing
    identity); returns the port's rows."""
    out_j, out_t = str(tmp_path / "jax.tsv"), str(tmp_path / "torch.tsv")
    jcli.main(_args(data_dir, out_j, "--max", str(n_max)))
    tcli.main(_args(data_dir, out_t, "--max", str(n_max - 1),
                    "--device", "cpu"))
    tcli.main(_args(data_dir, out_t, "--max", str(n_max), "--resume",
                    "--device", "cpu"))
    head_j, rows_j = _rows(out_j)
    head_t, rows_t = _rows(out_t)
    assert head_t == head_j == tcli.TSV_HEADER
    assert rows_t == rows_j
    assert all(r[3] == "1" for r in rows_t), rows_t   # all certified
    return rows_t


@pytest.mark.slow
def test_port_tsv_matches_jax_cli(data_dir, tmp_path):
    rows = _compare_clis(data_dir, tmp_path, 4)
    assert [r[0] for r in rows] == ["0", "1", "2"]


def test_port_tsv_matches_jax_cli_two_identities(data_dir, tmp_path):
    """The small case of the test above."""
    rows = _compare_clis(data_dir, tmp_path, 3)
    assert [r[0] for r in rows] == ["0", "1"]


def test_identity_order_matches_jax_striding():
    """--skip/--max striding with the reference's (i+1) arithmetic, then
    the contiguous --chunks split."""
    assert tcli.identity_order(10, 1, 4, 1, 0) == [0, 1, 2]
    assert tcli.identity_order(10, 2, -1, 1, 0) == [1, 3, 5, 7, 9]
    assert tcli.identity_order(10, 2, -1, 2, 1) == [7, 9]
    assert tcli.identity_order(10, 3, 6, 1, 0) == [2]
    with pytest.raises(SystemExit):
        tcli.identity_order(10, 1, -1, 2, 2)


@pytest.mark.parametrize("flag", [
    ["--adaptive", "guaranteed"], ["--adaptive-group", "4"],
    ["--adaptive-engine", "device"], ["--adaptive-chunk-batches", "2"],
    ["--adaptive-slack", "0.2"], ["--adaptive-gap-target", "1.0"],
    ["--mesh"], ["--mesh-id", "2"], ["--multihost"],
    ["--coordinator-address", "localhost:1"], ["--num-processes", "2"],
    ["--process-id", "1"], ["--cascade"], ["--synthesis-resolution", "16"],
    ["--native-embs-file", "x.npz"]])
def test_unported_flags_raise(tmp_path, flag):
    with pytest.raises(SystemExit, match="ROADMAP"):
        tcli.main(_args(str(tmp_path), str(tmp_path / "x.tsv"), *flag))
