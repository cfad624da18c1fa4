"""Shared by the benchmark's tests: BENCHMARK.json's cells cut to a size
the CPU runs in seconds (32^2 synthesis, a few identities and rows)."""

from __future__ import annotations

import time

import torch

from cfr_bench import families, harness
from cfr_bench.reference import pipeline as ref

TINY_TRAFFIC = {
    "certify": dict(n0=8, n=200, batch=8, identities=4, gallery=16,
                    check_batches=1),
    "attack": dict(batch=2, gallery=6, iters=2, restarts=1, check_calls=1,
                   check_steps=1, n_target_classes=1),
}


def bench() -> dict:
    return harness.load_json(harness.CHECKOUT / "BENCHMARK.json")


def tiny_cell(name: str, dtype: str = "f32", seed: int = 2 ** 31 + 7):
    """(ctx, driver) of cell ``name`` at 32^2 on the CPU."""
    return tiny_ctx(*harness.cell_spec(name, bench()), dtype, seed)


def tiny_ctx(cell: dict, config: dict, traffic: dict, dtype: str = "f32",
             seed: int = 2 ** 31 + 7):
    """(ctx, driver) of a cell's (entry, configuration, traffic) cut to
    32^2 on the CPU: the configuration at the widths its families build
    there, the traffic at TINY_TRAFFIC's sizes."""
    config = dict(config, resolution=32, dtype=dtype, env={},
                  **ref.widths(*families.of(config), 32))
    traffic = dict(traffic, **TINY_TRAFFIC[traffic["kind"]])
    driver = harness.load_module(harness.HERE / "drivers"
                                 / f"{traffic['kind']}.py")
    return harness.Ctx(cell, config, traffic, seed, torch.device("cpu"),
                       1), driver


def run_tiny(name: str, trace: bool = False, dtype: str = "f32") -> dict:
    ctx, driver = tiny_cell(name, dtype)
    return harness.run_cell(ctx, 0.0, trace, driver, bench(),
                            time.perf_counter())
