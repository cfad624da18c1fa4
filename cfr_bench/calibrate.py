"""Readings for the limits of ``correct``: for each seed, the cell's
program through one unit at the cell's own load (an identity, an
attack), its compared numbers and ``correct`` as a run decides it; the
same with the control (the reference in float8 standing in for the
program) on the same inputs; with a fault of ``cfr_bench.faults``
planted in the timed path once set-up is done; and, for certify cells,
the witness of the program's embedding error (the reference in bfloat16
against the reference in float32, on the latents the check compared).
One JSON line per seed and side.

    python3 -m cfr_bench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--witness-seeds 1,2,3] \\
        [--faults alter_answers,half_batch --fault-seeds 1,2,3]

The limits in the configuration files were set from these readings
(PERF.md gives them); the benchmark's own runs never run the control or
a fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from cfr_bench import faults, harness, program


def cell(workload: str, seed: int):
    """(ctx, driver) of ``workload`` on the card."""
    import torch

    bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    spec, config, traffic = harness.cell_spec(workload, bench)
    harness.set_environment(config)
    driver = harness.load_module(harness.HERE / "drivers"
                                 / f"{traffic['kind']}.py")
    return harness.Ctx(spec, config, traffic, seed, torch.device("cuda", 0),
                       spec["chips"]), driver


def side(driver, state, control: bool = False) -> dict:
    checks = driver.check(state, control=control)
    return {"correct": harness.is_correct(checks),
            "checks": {c["name"]: c["value"] for c in checks},
            "info": dict(getattr(state, "info", {}))}


def readings(ctx, driver, control: bool = False, witness: bool = False,
             fault: str = "") -> dict:
    """One unit of the cell's program (``fault`` planted after set-up),
    then the check; the control and the witness on the same inputs."""
    import torch

    t0 = time.perf_counter()
    state = driver.setup(ctx)
    patches = faults.Patches()
    if fault:
        faults.FAULTS[fault](patches.set)
    try:
        driver.run_unit(state, 0)
    finally:
        patches.undo()
    driver.release(state)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"workload": ctx.cell["name"], "seed": ctx.seed, "fault": fault,
           "program": side(driver, state)}
    cmp = getattr(state, "compared", None)
    if witness and cmp is not None:
        from cfr_bench.reference.precision import BF16

        e16 = program.reference_embed(state.p, cmp["w"], BF16, 8)
        rel = program.rel_err(e16, cmp["e_ref"])
        out["witness_bf16_reference"] = {"emb_err": float(rel.max()),
                                         "emb_err_median": float(
                                             rel.median())}
    if control:
        out["control"] = side(driver, state, control=True)
    out["seconds"] = time.perf_counter() - t0
    del state
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    args = p.parse_args(argv)
    ctrl = set(_seeds(args.control_seeds))
    wit = set(_seeds(args.witness_seeds))
    for s in _seeds(args.seeds):
        ctx, driver = cell(args.workload, s)
        print(json.dumps(readings(ctx, driver, s in ctrl, s in wit)),
              flush=True)
    for name in [f for f in args.faults.split(",") if f]:
        for s in _seeds(args.fault_seeds):
            ctx, driver = cell(args.workload, s)
            print(json.dumps(readings(ctx, driver, fault=name)), flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
