"""Multi-device certification in the port (torch.distributed, one process
per device) against the JAX package's mesh:

  * merge_shard_winners, fed each shard's nearest_refined winners, gives
    the JAX package's sharded_argmin_dist under shard_map on the harness's
    8 virtual CPU devices (id axis 2 and 4, both metrics, exact and near
    ties across shards), and over uneven blocks the single-device argmin;
  * rank -> (mc, id) is get_2d_mesh's device order;
  * in one process, with the all-reduce left out, the counts of the mc
    slices of a batch sum to the unsharded batch's counts;
  * real multi-process gloo runs of cfr-certify-torch --device cpu --mesh
    --multihost (2 processes; 4 with --mesh-id 2 over an uneven gallery;
    2 with the adaptive device engine) write, from rank 0 only, the TSV of
    a one-process run of the same flags in its idx..radius columns. The
    last two resume a partial TSV that only rank 0 can see (the
    one-process run resumes its own copy), so only the broadcast of rank
    0's done-set keeps the ranks' collective calls aligned.

The CLI runs use the settings of test_torch_certify_cli.py (16^2, N0 8,
N 16, batch 8, sigma 0.001, where every sample keeps its label, He-scaled
iresnet-18 weights as .npz). Each subprocess has its own 120 s timeout:
on expiry every process of the run is killed and the test fails."""

import os
import os.path as osp
import socket
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from certifyingfacerecognition_tpu.parallel.gallery import \
    sharded_argmin_dist
from certifyingfacerecognition_tpu.parallel.mesh import get_2d_mesh
from certifyingfacerecognition_torch.cli import certify as tcli
from certifyingfacerecognition_torch.models import iresnet
from certifyingfacerecognition_torch.models.pipeline import FacePipeline
from certifyingfacerecognition_torch.ops import distances as D
from certifyingfacerecognition_torch.ops.geometry import get_all_matrices
from certifyingfacerecognition_torch.parallel import gallery as G
from certifyingfacerecognition_torch.parallel.mesh import Mesh, rank_coords
from certifyingfacerecognition_torch.smoothing import smooth
from certifyingfacerecognition_torch.smoothing.certificate import \
    L2Certificate
from certifyingfacerecognition_torch.utils import weights as W

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
RES = 16
N_IDS = 5                 # an uneven gallery for --mesh-id 2: rows 3 + 2
TIMEOUT = 120
torch.set_num_threads(1)


def _gallery_with_ties(n, b, seed, near=1e-6):
    """A gallery [n, 512] of unit rows (embeddings) and queries [b, 512]:
    the queries are rows of the first shard, duplicated exactly in the
    last shard and nearly (``near`` away) in the middle."""
    rng = np.random.default_rng(seed)
    gallery = rng.standard_normal((n, 512)).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    x = gallery[:b].copy()
    gallery[n - b:] = gallery[:b]
    gallery[n // 2:n // 2 + b] = gallery[:b] + near
    return gallery, x


def _port_sharded(x, gallery, n_id, method):
    dists, idx = [], []
    for i in range(n_id):
        lo, hi = G.shard_rows(len(gallery), n_id, i)
        d, local = D.nearest_refined(torch.from_numpy(x),
                                     torch.from_numpy(gallery[lo:hi]), method)
        dists.append(d)
        idx.append(local + lo)
    return G.merge_shard_winners(torch.stack(dists), torch.stack(idx)).numpy()


@pytest.mark.parametrize("method", ["insightface", "facenet"])
@pytest.mark.parametrize("n_id", [2, 4])
def test_merge_shard_winners_matches_jax(n_id, method):
    """FaceNet's cosine distance has no exact refinement, so its near ties
    are 1e-4 away: closer ones fall to each framework's matmul rounding."""
    gallery, x = _gallery_with_ties(
        64, 8, seed=n_id, near=1e-6 if method == "insightface" else 1e-4)
    x = np.concatenate([x, np.random.default_rng(1).standard_normal(
        (8, 512)).astype(np.float32)])
    mesh = get_2d_mesh(8 // n_id, n_id)

    @partial(shard_map, mesh=mesh, in_specs=(P(), P("id")), out_specs=P(),
             check_vma=False)
    def run(x, shard):
        return sharded_argmin_dist(x, shard, method)

    want = np.asarray(run(jnp.asarray(x), jnp.asarray(gallery)))
    got = _port_sharded(x, gallery, n_id, method)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, D.argmin_dist_refined(
        torch.from_numpy(x), torch.from_numpy(gallery), method).numpy())
    if method == "insightface":         # exact hits: the lowest index
        np.testing.assert_array_equal(got[:8], np.arange(8))


def test_uneven_shards_match_single_device():
    gallery, x = _gallery_with_ties(61, 8, seed=0)
    assert [G.shard_rows(61, 4, i) for i in range(4)] == \
        [(0, 16), (16, 31), (31, 46), (46, 61)]
    want = D.argmin_dist_refined(torch.from_numpy(x),
                                 torch.from_numpy(gallery)).numpy()
    np.testing.assert_array_equal(_port_sharded(x, gallery, 4,
                                                "insightface"), want)
    with pytest.raises(ValueError):
        G.shard_rows(3, 4, 0)


@pytest.mark.parametrize("n_mc,n_id", [(4, 2), (2, 4), (8, 1), (1, 8)])
def test_rank_coords_match_jax_2d_mesh(n_mc, n_id):
    mesh = get_2d_mesh(n_mc, n_id)
    for (mc, id_), dev in np.ndenumerate(mesh.devices):
        assert rank_coords(jax.devices().index(dev), n_id) == (mc, id_)


@pytest.mark.parametrize("n_mc", [2, 4])
def test_mc_slices_sum_to_unsharded_counts(monkeypatch, n_mc):
    """Each mc rank's counts (all-reduce left out) over a ragged batch (6
    valid of 8), against one process's: the slices partition the batch's
    samples, and every rank draws the same noise."""
    monkeypatch.setattr(smooth.dist, "all_reduce",
                        lambda tensor, group=None: None)
    centres = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (6, 5)).astype(np.float32))

    def predict(z, p):                  # nearest of six centres
        return torch.cdist(p + z[:5], centres).argmin(1)

    def counts(mesh):
        fn = smooth._make_batch_fn(predict, 6, L2Certificate(), 8, 5, "cpu",
                                   mesh=mesh)
        gen = torch.Generator().manual_seed(7)
        return fn(None, torch.zeros(512), torch.zeros(5),
                  torch.full((5,), 1.0), gen, 6)

    want = counts(None)
    got = sum(counts(Mesh(n_mc, 1, m, 0)) for m in range(n_mc))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert float(want.sum()) == 6.0 and int((want > 0).sum()) > 1


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """w.npy, He-scaled iresnet-18 weights and the port's 16^2 gallery."""
    d = str(tmp_path_factory.mktemp("mesh"))
    ws = np.random.default_rng(0).standard_normal((N_IDS, 512)).astype(
        np.float32)
    np.save(osp.join(d, "w.npy"), ws)
    frm = iresnet.convert_state_dict_np(iresnet.random_torch_style_state_dict(
        "iresnet18", seed=0, realistic=True), "iresnet18")
    W.save_params(osp.join(d, "frm.npz"), frm)
    pipe = FacePipeline(W.load_generator_params("random", resolution=RES,
                                                device="cpu"),
                        W.load_params(osp.join(d, "frm.npz"), "cpu"),
                        dirs=torch.as_tensor(get_all_matrices().dirs.T),
                        resolution=RES, device="cpu")
    np.savez(osp.join(d, "embs_insightface.npz"),
             embs=pipe.lat2embs(ws).numpy())
    return d


def _args(data_dir, out, *extra):
    return ["--face-recog-model", "insightface", "--outfile", out,
            "--sigma", "0.001", "--data-dir", data_dir, "--resolution",
            str(RES), "--frm-weights", osp.join(data_dir, "frm.npz"),
            "--N0", "8", "--N", "16", "--batch-sz", "8", "--max", "4",
            "--device", "cpu", *extra]


def _rows(path):
    lines = open(path).read().strip().split("\n")
    assert lines[0] == tcli.TSV_HEADER
    return [line.split("\t")[:6] for line in lines[1:]]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_group(data_dir, cwds, *extra, single_cwd=None):
    """cfr-certify-torch --mesh --multihost in len(cwds) processes, rank r
    in cwds[r], writing the relative outfile mh.tsv; with ``single_cwd``,
    the one-process run of the same flags beside them. Their outputs."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    base = _args(data_dir, "mh.tsv", *extra)
    group = ["--mesh", "--multihost", "--coordinator-address",
             f"localhost:{_free_port()}", "--num-processes", str(len(cwds))]
    runs = [(base + group + ["--process-id", str(r)], cwd)
            for r, cwd in enumerate(cwds)]
    if single_cwd is not None:
        runs.append((base, single_cwd))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "certifyingfacerecognition_torch.cli.certify",
         *argv], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for argv, cwd in runs]
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
                raise AssertionError(f"process {len(outs)} did not finish in "
                                     f"{TIMEOUT} s:\n{out[-4000:]}")
            assert p.returncode == 0, out[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _cwds(tmp_path, n):
    cwds = [tmp_path / f"rank{r}" for r in range(n)]
    for c in cwds:
        c.mkdir()
    return [str(c) for c in cwds]


def _assert_ranks(outs, world, n_id):
    for r, out in enumerate(outs[:world]):
        assert (f"distributed: rank {r} of {world}, backend gloo, mesh mc "
                f"{world // n_id} x id {n_id}") in out, out[-2000:]


def test_two_process_mesh_matches_one_process(data_dir, tmp_path):
    cwds = _cwds(tmp_path, 3)
    _assert_ranks(_run_group(data_dir, cwds[:2], single_cwd=cwds[2]), 2, 1)
    assert not osp.exists(osp.join(cwds[1], "mh.tsv")), "rank 1 wrote"
    want = _rows(osp.join(cwds[2], "mh.tsv"))
    assert [r[0] for r in want] == ["0", "1", "2"]
    assert _rows(osp.join(cwds[0], "mh.tsv")) == want


def _partial(cwds, n_rows):
    """A TSV holding marker rows for identities 0..n_rows-1 (kept as they
    are by --resume) in each of ``cwds``; the marker rows."""
    marker = [[str(i), str(i), "-1", "0", "0.0", "0.0", "0:00:00"]
              for i in range(n_rows)]
    for cwd in cwds:
        with open(osp.join(cwd, "mh.tsv"), "w") as f:
            f.write("\n".join([tcli.TSV_HEADER]
                              + ["\t".join(m) for m in marker]) + "\n")
    return [m[:6] for m in marker]


def test_four_process_sharded_gallery_resume_matches_one_process(
        data_dir, tmp_path):
    """2 mc x 2 id ranks over a 5-row gallery (blocks of 3 and 2 rows),
    resuming a TSV with rows for identities 0 and 1 that only rank 0 sees
    (the one-process run resumes its own copy)."""
    cwds = _cwds(tmp_path, 5)
    marker = _partial([cwds[0], cwds[4]], 2)
    outs = _run_group(data_dir, cwds[:4], "--mesh-id", "2", "--resume",
                      single_cwd=cwds[4])
    _assert_ranks(outs, 4, 2)
    for out in outs:
        assert "Resuming: 2 identities already certified" in out, out[-2000:]
    assert not any(osp.exists(osp.join(c, "mh.tsv")) for c in cwds[1:4])
    want = _rows(osp.join(cwds[4], "mh.tsv"))
    assert [r[0] for r in want] == ["0", "1", "2"] and want[:2] == marker
    assert _rows(osp.join(cwds[0], "mh.tsv")) == want


def test_two_process_adaptive_device_engine_matches_one_process(
        data_dir, tmp_path):
    """The device engine reads a status computed from all-reduced counts,
    so both ranks take every branch together (a rank that stopped alone
    would leave the other waiting in an all-reduce until the timeout).
    Identities 0 and 1 are resumed, so one identity is certified."""
    cwds = _cwds(tmp_path, 3)
    _partial([cwds[0], cwds[2]], 2)
    outs = _run_group(data_dir, cwds[:2], "--adaptive", "guaranteed",
                      "--adaptive-engine", "device",
                      "--adaptive-chunk-batches", "1", "--resume",
                      single_cwd=cwds[2])
    _assert_ranks(outs, 2, 1)
    want = _rows(osp.join(cwds[2], "mh.tsv"))
    assert [r[0] for r in want] == ["0", "1", "2"]
    assert _rows(osp.join(cwds[0], "mh.tsv")) == want
    assert not osp.exists(osp.join(cwds[1], "mh.tsv")), "rank 1 wrote"
    for out in outs:
        assert out.count("adaptive[guaranteed] id 2: 24/24 samples") == 1, \
            out[-2000:]
