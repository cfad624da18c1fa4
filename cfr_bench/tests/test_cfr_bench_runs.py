"""Whole runs of each cell at 32^2 on the CPU: the result line, the
traced metrics, the refusal without a card, and correct coming out false
with the timed path broken underneath."""

import json

import pytest
import torch

import conftest_helpers as H
from cfr_bench import calibrate, faults, harness

CELLS = [w["name"] for w in H.bench()["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    res = H.run_tiny(cell)
    assert KEYS <= set(res) and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(H.bench(), "end_to_end",
                                                    cell)}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line(cell):
    res = H.run_tiny(cell, trace=True)
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU there is no device trace and no tail at 32^2: what a
    # reader cannot read is left out, never reported as 0
    for name, v in res["metrics"].items():
        assert v["value"] is not None
        if name.endswith("roofline") or "mfu" in name:
            assert v["value"] > 0


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                       "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


FAULTS = [("sg1024-r50.certify", "alter_answers", "head_miss"),
          ("sg1024-r50.certify", "half_batch", "emb_err"),
          ("sg1024-r50.certify", "still_noise", "noise_z"),
          ("sg1024-r50.certify", "half_counted", "cert_miss"),
          ("sg1024-facenet.certify", "alter_answers", "head_miss"),
          ("sg1024-facenet.certify", "half_counted", "cert_miss"),
          ("sg1024-facenet.certify", "half_batch", "pair_err"),
          ("sg1024-r50.pgd", "found_everything", "false_success"),
          ("sg1024-r50.pgd", "half_batch", "dist_err"),
          ("sg1024-r50.pgd", "step_unchanged", "step_angle"),
          ("sg1024-r50.fabt", "fab_found_everything", "false_success"),
          ("sg1024-r50.fabt", "half_batch", "dist_err")]


@pytest.mark.parametrize("cell,fault,number", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_broken_path_is_not_correct(cell, fault, number, monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
    res = H.run_tiny(cell)
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("cell,fault,number",
                         [("sg1024-facenet.certify", "alter_answers",
                           "head_miss"),
                          ("sg1024-facenet.certify", "half_batch",
                           "pair_err"),
                          ("sg1024-r50.certify", "half_counted",
                           "cert_miss")])
def test_fault_planted_after_setup_is_not_correct(cell, fault, number):
    # as cfr_bench.calibrate reads the faults on the card: in the timed
    # path alone, the program's set-up and gallery left sound
    ctx, driver = H.tiny_cell(cell)
    out = calibrate.readings(ctx, driver, fault=fault)
    assert out["program"]["correct"] is False
    assert out["program"]["checks"][number] > \
        ctx.config["limits"]["certify"][number]
    assert set(faults.FAULTS) >= {f for _, f, _ in FAULTS}


@pytest.mark.parametrize("cell", ["sg1024-r50.certify",
                                  "sg1024-facenet.certify"])
def test_control_is_not_correct(cell):
    # the float8 control through the comparison that decides a run's
    # correct, with the cell's own limits
    ctx, driver = H.tiny_cell(cell)
    out = calibrate.readings(ctx, driver, control=True, witness=True)
    assert out["program"]["correct"] is True
    assert out["control"]["correct"] is False
    assert out["witness_bf16_reference"]["emb_err"] < \
        out["control"]["checks"]["emb_err"]
