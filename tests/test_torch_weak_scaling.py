"""Weak-scaling structure of the port's sharded counts program
(tools/weak_scaling), as tests/test_weak_scaling.py holds the JAX
package's, over 1, 2 and 4 gloo ranks (one process each beyond the
first) at resolution 32, 2 samples per rank per batch, 2 batches, 64
classes:

* FLOPs per rank per sample (FlopCounterMode: matrix products and
  convolutions) constant within 2% and above 1e8, the real pipeline;
* no collective at one rank; at more, exactly one all_reduce of the
  class counts (4 x classes bytes) per batch;
* the bytes follow the classes, not the batch: the same at 2 and 4 ranks
  (4 and 8 samples per batch), 4 x 128 with 128 classes at 1 sample per
  rank.

Wall-clock efficiency is not asserted: the ranks share this host's cores.
Each rank process has a 120 s limit; on expiry every rank is killed and
the test fails."""

import pytest
import torch

from certifyingfacerecognition_torch.tools import weak_scaling as WS

N_GALLERY = 64
TIMEOUT = 120
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rows():
    return WS.run_scan(device_counts=[1, 2, 4], per_dev_batch=2,
                       n_batches=2, resolution=32, n_gallery=N_GALLERY,
                       time_it=False, device="cpu", timeout=TIMEOUT)


def test_weak_scaling_flops_constant(rows):
    assert [r["devices"] for r in rows] == [1, 2, 4]
    assert [r["batch"] for r in rows] == [2, 4, 8]
    base = rows[0]["flops_per_device_per_sample"]
    assert base > 1e8
    for r in rows[1:]:
        ratio = r["flops_per_device_per_sample"] / base
        assert abs(ratio - 1.0) < 0.02, (r["devices"], ratio)


def test_weak_scaling_collectives(rows):
    assert rows[0]["collectives"] == []
    assert rows[0]["collective_bytes_per_batch"] == 0
    for r in rows[1:]:
        assert r["collectives"] == [{"kind": "all_reduce",
                                     "bytes": 4 * N_GALLERY}]
        assert r["collective_bytes_per_batch"] == 4 * N_GALLERY
        assert r["device"] == "cpu"


def test_weak_scaling_bytes_scale_with_classes_not_batch(rows):
    big_gal = WS.run_scan(device_counts=[2], per_dev_batch=1, n_batches=2,
                          resolution=32, n_gallery=128, time_it=False,
                          device="cpu", timeout=TIMEOUT)[0]
    assert rows[1]["collective_bytes_per_batch"] == \
        rows[2]["collective_bytes_per_batch"] == 4 * N_GALLERY
    assert big_gal["collectives"] == [{"kind": "all_reduce", "bytes": 4 * 128}]
    assert abs(big_gal["flops_per_device_per_sample"]
               / rows[1]["flops_per_device_per_sample"] - 1.0) < 0.05


def test_more_ranks_than_gpus_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL puts no two ranks"):
        WS.run_scan(device_counts=[1, 2], device="cuda")


def test_time_it_rows():
    """One rank, timed: samples/s and the wall-clock semantics."""
    row = WS.run_scan(device_counts=[1], per_dev_batch=1, n_batches=1,
                      resolution=16, n_gallery=8, time_it=True,
                      device="cpu")[0]
    assert row["wall_s_per_scan"] > 0 and row["samples_per_s"] > 0
    assert row["parallel_efficiency"] == 1.0
    assert row["wallclock_semantics"] == "parallel (cores >= ranks)"
