"""The port's certify CLI against the JAX CLI on one tiny data directory:
32^2, random generator weights, random He-scaled ArcFace weights saved as
.npz (the default random:0 ArcFace weights drive every embedding to NaN,
where the nearest identity is arbitrary), a gallery of four identities
computed by the JAX pipeline at 32^2 and one at 16^2 (the reduced-
resolution gallery), sigma small enough that every noisy sample keeps its
label (so the counts, and hence every decision and every early stop, do
not depend on the two frameworks' different noise streams). The TSV
header and the idx, label, predict, correct, gap and radius columns must
match row for row: fixed N, --adaptive in both modes and with every
engine, and --synthesis-resolution 16 --cascade, whose certified rows must
also equal a plain native run's. The adaptive runs' samples-used lines
must match too. FaceNet (--face-recog-model facenet, the random:0 FaceNet
weights, a gallery from the JAX facenet pipeline at 32^2) in f32: the
same rows for two identities; on random weights its embeddings are
nearly equal, so these decisions are held equal in f32 only.

Torch runs one intra-op thread per process: the suite runs in several
pytest-xdist workers that share the machine's cores."""

import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifyingfacerecognition_tpu.cli import certify as jcli
from certifyingfacerecognition_tpu.models import facenet, iresnet
from certifyingfacerecognition_tpu.models.pipeline import FacePipeline
from certifyingfacerecognition_tpu.ops import geometry as G
from certifyingfacerecognition_tpu.utils import weights as W
from certifyingfacerecognition_torch.cli import certify as tcli

RES, SR = 32, 16
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
    gen = W.load_generator_params("random", resolution=RES)
    for res, name in ((RES, "embs_insightface.npz"),
                      (SR, f"embs_insightface_sr{SR}.npz")):
        pipe = FacePipeline(gen, frm,
                            dirs=jnp.asarray(G.get_all_matrices().dirs.T),
                            resolution=res)
        np.savez(osp.join(d, name),
                 embs=np.asarray(pipe.lat2embs(jnp.asarray(ws))))
    pipe = FacePipeline(gen, facenet.random_params(0),
                        dirs=jnp.asarray(G.get_all_matrices().dirs.T),
                        frs_method="facenet", resolution=RES)
    np.savez(osp.join(d, "embs_facenet.npz"),
             embs=np.asarray(pipe.lat2embs(jnp.asarray(ws))))
    return str(d)


def _args(data_dir, out, *extra):
    return ["--face-recog-model", "insightface", "--outfile", out,
            "--sigma", "0.001", "--data-dir", data_dir, "--resolution",
            str(RES), "--frm-weights", osp.join(data_dir, "frm.npz"), "--N0", "8", "--N", "16", "--batch-sz", "8", *extra]


def _rows(path):
    lines = open(path).read().strip().split("\n")
    return lines[0], [line.split("\t")[:6] for line in lines[1:]]


def _facenet_args(data_dir, out, *extra):
    """_args with --face-recog-model facenet and the random:0 FaceNet
    weights."""
    args = _args(data_dir, out, *extra)
    args[1] = "facenet"
    args[args.index("--frm-weights") + 1] = "random:0"
    return args


def _compare_clis(data_dir, tmp_path, n_max, make_args=_args):
    """The JAX CLI with --max n_max against the port's, run as --max
    n_max - 1 then --resume --max n_max (which appends only the missing
    identity); returns the port's rows."""
    out_j, out_t = str(tmp_path / "jax.tsv"), str(tmp_path / "torch.tsv")
    jcli.main(make_args(data_dir, out_j, "--max", str(n_max)))
    tcli.main(make_args(data_dir, out_t, "--max", str(n_max - 1),
                        "--device", "cpu"))
    tcli.main(make_args(data_dir, out_t, "--max", str(n_max), "--resume",
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


def test_port_tsv_matches_jax_cli_facenet(data_dir, tmp_path):
    """The two-identity case with FaceNet, f32."""
    rows = _compare_clis(data_dir, tmp_path, 3, _facenet_args)
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


def _small(data_dir, out, *extra):
    """Identities 0 and 1 with a budget of five batches of two (N0 2, N 8)
    at alpha 0.1: sequential mode's checkpoint bound clears 0.5 at 6 of 8
    samples, where a gap target of 0.01 stops it early."""
    args = _args(data_dir, out, "--max", "3", *extra)
    for flag, value in (("--N0", "2"), ("--N", "8"), ("--batch-sz", "2")):
        args[args.index(flag) + 1] = value
    return args + ["--alpha", "0.1"]


def _run(cli, argv, capsys):
    """(TSV header, rows, the adaptive samples-used lines) of one run."""
    capsys.readouterr()
    cli.main(argv)
    lines = [line for line in capsys.readouterr().out.split("\n")
             if line.startswith("adaptive[")]
    return (*_rows(argv[argv.index("--outfile") + 1]), lines)


ADAPTIVE = {"guaranteed": ["--adaptive", "guaranteed",
                           "--adaptive-chunk-batches", "1"],
            "sequential": ["--adaptive", "sequential",
                           "--adaptive-chunk-batches", "1",
                           "--adaptive-gap-target", "0.01"]}
_JAX_RUNS = {}


def _jax_run(key, data_dir, tmp_path, capsys, *flags):
    """The JAX CLI's run of ``flags``, once per module."""
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _run(jcli, _small(data_dir, str(tmp_path / "j.tsv"),
                                           *flags), capsys)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("mode,engine", [
    ("guaranteed", ["--adaptive-engine", "host"]),
    ("guaranteed", ["--adaptive-engine", "device"]),
    ("guaranteed", ["--adaptive-engine", "device", "--adaptive-group", "2"]),
    ("sequential", ["--adaptive-engine", "host"]),
    ("sequential", ["--adaptive-engine", "device", "--adaptive-group", "2"])],
    ids=["guaranteed-host", "guaranteed-device", "guaranteed-group2",
         "sequential-host", "sequential-group2"])
def test_adaptive_tsv_matches_jax_cli(data_dir, tmp_path, capsys, mode,
                                      engine):
    """Against the JAX CLI's host engine (which its own tests hold equal to
    its device engine and groups on these rules)."""
    want = _jax_run(mode, data_dir, tmp_path, capsys, *ADAPTIVE[mode])
    got = _run(tcli, _small(data_dir, str(tmp_path / "t.tsv"),
                            *ADAPTIVE[mode], *engine, "--device", "cpu"),
               capsys)
    assert got == want
    head, rows, used = got
    assert head == tcli.TSV_HEADER and [r[0] for r in rows] == ["0", "1"]
    assert all(r[3] == "1" for r in rows), rows          # all certified
    assert used == [f"adaptive[{mode}] id {i}: "
                    f"{8 if mode == 'sequential' else 10}/10 samples"
                    for i in (0, 1)]


def test_cascade_matches_jax_cli_and_native_rows(data_dir, tmp_path,
                                                 capsys):
    """--synthesis-resolution 16 --cascade at --resolution 32, fixed N:
    the JAX CLI's rows, and every certified row equal to the plain native
    run's (the native pass draws exactly the native run's noise)."""
    flags = ["--synthesis-resolution", str(SR), "--cascade"]
    want = _jax_run("cascade", data_dir, tmp_path, capsys, *flags)
    got = _run(tcli, _small(data_dir, str(tmp_path / "t.tsv"), *flags,
                            "--device", "cpu"), capsys)
    assert got == want
    _, native, _ = _run(tcli, _small(data_dir, str(tmp_path / "n.tsv"),
                                     "--device", "cpu"), capsys)
    certified = [r for r in got[1] if r[3] == "1"]
    assert certified and certified == [r for r in native if r[3] == "1"]


@pytest.mark.parametrize("cli", [jcli, tcli], ids=["jax", "torch"])
@pytest.mark.parametrize("flags", [
    ["--adaptive", "guaranteed", "--adaptive-group", "2"],
    ["--adaptive", "sequential", "--adaptive-group", "2",
     "--adaptive-engine", "device", "--synthesis-resolution", str(SR),
     "--cascade"],
    ["--cascade"],
    ["--cascade", "--synthesis-resolution", str(RES), "--embs-file",
     "{native}"]],
    ids=["group-host", "group-cascade", "cascade-native",
         "cascade-not-lower"])
def test_usage_errors_raise(data_dir, tmp_path, cli, flags):
    flags = [f.format(native=osp.join(data_dir, "embs_insightface.npz"))
             for f in flags]
    extra = ["--device", "cpu"] if cli is tcli else []
    with pytest.raises(SystemExit, match="--"):
        cli.main(_small(data_dir, str(tmp_path / "x.tsv"), *flags, *extra))


@pytest.mark.parametrize("flag", [
    ["--mesh"], ["--mesh-id", "2"], ["--multihost"],
    ["--coordinator-address", "localhost:1"], ["--num-processes", "2"],
    ["--process-id", "1"]])
def test_unported_flags_raise(tmp_path, flag):
    with pytest.raises(SystemExit, match="ROADMAP"):
        tcli.main(_args(str(tmp_path), str(tmp_path / "x.tsv"), *flag))
