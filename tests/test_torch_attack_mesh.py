"""cfr-attack-torch --mesh / --multihost: each rank of a torch.distributed
group attacks whole batches of --batch-size identities (batch j of a
chunk on rank j % world) and rank 0 gathers them back into batch order,
re-verifies and writes every artifact.

* rank_batches / merge_rank_batches as pure functions, for world sizes
  1-4 over batch counts that do and do not divide among the ranks
  (fewer batches than ranks included): every batch on exactly one rank,
  in order, and merged back in batch order; a missing or doubled batch
  raises;
* real 2-process gloo runs of cfr-attack-torch --device cpu --multihost,
  with and without --mesh, at 16^2 on 3 identities at --batch-size 1
  (rank 0 attacks batches 0 and 2, rank 1 batch 1), PGD 1 restart x 2
  iterations, with the He-scaled iresnet-18 .npz FRM of
  test_torch_parallel.py, against one in-process one-process run of the
  same flags: the chunk's npz (deltas, successes, magnitudes), its log,
  results.txt and the cumulative per-batch log lines are equal (f32, the
  same per-batch seeds), and rank 1's working directory holds no
  exp_results.

Each subprocess has its own 120 s timeout: on expiry every process of the
run is killed and the test fails."""

import os
import os.path as osp
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from certifyingfacerecognition_torch.cli import main_attack as tmain
from certifyingfacerecognition_torch.eval import chunk_runner as tcr
from certifyingfacerecognition_torch.models import iresnet
from certifyingfacerecognition_torch.utils import weights as W

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
RES = 16
TIMEOUT = 120
torch.set_num_threads(1)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_rank_batches_and_merge(world):
    for n_batches in (1, 2, 3, 5, 7, 8):
        per_rank = [tcr.rank_batches(n_batches, world, r)
                    for r in range(world)]
        assert sorted(j for js in per_rank for j in js) == \
            list(range(n_batches))
        for r, js in enumerate(per_rank):
            assert js == sorted(js) and all(j % world == r for j in js)
        parts = [{j: f"batch{j}" for j in js} for js in per_rank]
        assert tcr.merge_rank_batches(parts, n_batches) == \
            [f"batch{j}" for j in range(n_batches)]
    # fewer batches than ranks: the extra ranks get none
    assert tcr.rank_batches(1, world, world - 1) == ([0] if world == 1
                                                     else [])
    with pytest.raises(ValueError):
        tcr.merge_rank_batches([{0: 0}, {0: 0}], 1)
    with pytest.raises(ValueError):
        tcr.merge_rank_batches([{0: 0}, {2: 2}], 3)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _argv(data_dir):
    return ["--output-dir", "mh", "--data-dir", data_dir, "--chunks", "1",
            "--batch-size", "1", "--resolution", str(RES), "--iters", "2",
            "--restarts", "1", "--seed", "1", "--scale-factor", "1e-4",
            "--device", "cpu", "--frm-weights",
            osp.join(data_dir, "frm.npz")]


def _run_group(argv, cwds, flags=("--mesh",)):
    """cfr-attack-torch --multihost (with ``flags``) in len(cwds)
    processes, rank r in cwds[r]; their outputs."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    group = [*flags, "--multihost", "--coordinator-address",
             f"localhost:{_free_port()}", "--num-processes", str(len(cwds))]
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "certifyingfacerecognition_torch.cli.main_attack", *argv, *group,
         "--process-id", str(r)], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r, cwd in enumerate(cwds)]
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


def _progress(text):
    return re.findall(r"-> \d+ advs for \d+ IDs -> avg\. pert\.: [\d.]+",
                      text)


@pytest.fixture(scope="module")
def single_run(tmp_path_factory):
    """The data directory, the argv and the working directory of an
    in-process one-process run of that argv."""
    root = tmp_path_factory.mktemp("attack_mesh")
    data = root / "data"
    data.mkdir()
    np.save(data / "w.npy", np.random.default_rng(1).standard_normal(
        (3, 512)).astype(np.float32))
    W.save_params(str(data / "frm.npz"), iresnet.convert_state_dict_np(
        iresnet.random_torch_style_state_dict("iresnet18", seed=0,
                                              realistic=True), "iresnet18"))
    single = root / "single"
    single.mkdir()
    argv = _argv(str(data))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(single)
        tmain.main(argv)
    return argv, single


def _check_group_run(single_run, tmp_path, flags):
    """Run the 2-process group with ``flags`` and hold rank 0's artifacts
    and logs to the one-process run's; rank 1 writes nothing."""
    argv, single_cwd = single_run
    cwds = [tmp_path / name for name in ("rank0", "rank1")]
    for c in cwds:
        c.mkdir()
    outs = _run_group(argv, [str(c) for c in cwds], flags)
    for r, out in enumerate(outs):
        assert f"distributed: rank {r} of 2, backend gloo" in out, out[-2000:]
    assert not osp.exists(cwds[1] / "exp_results"), "rank 1 wrote"

    single, rank0 = (c / "exp_results" / "mh" for c in (single_cwd, cwds[0]))
    npz = osp.join("results", "results_chunk0of1.npz")
    assert osp.isfile(single / npz), "no adversary: nothing to compare"
    with np.load(single / npz) as want, np.load(rank0 / npz) as got:
        assert sorted(got.files) == ["deltas", "magnitudes", "successes"]
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for name in (osp.join("logs", "results_chunk0of1.txt"), "results.txt"):
        assert (rank0 / name).read_text() == (single / name).read_text()
    want = _progress((single / "chunk_all" / "log.txt").read_text())
    assert len(want) == 3 and want[-1].startswith("-> ")
    assert _progress(outs[0]) == want and _progress(outs[1]) == []


def test_two_process_attack_mesh_matches_one_process(single_run, tmp_path):
    _check_group_run(single_run, tmp_path, ("--mesh",))


def test_two_process_multihost_alone_splits_batches(single_run, tmp_path):
    """--multihost without --mesh: the same decomposition, rank 0 alone
    writes."""
    _check_group_run(single_run, tmp_path, ())
