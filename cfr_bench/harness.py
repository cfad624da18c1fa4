"""Run one cell of BENCHMARK.json once:

    python3 -m cfr_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``); the mix's ``kind`` names the driver
(``drivers/<kind>.py``), and each per-layer metric of the cell is read by
``metrics/<metric>.py``. The harness sets the caches and the
configuration's environment, has the driver set up the program (weights,
gallery, warm-up of the cell's shapes: ``setup_s``), runs the driver's
units (an identity, an attack) until ``--seconds`` have passed and
finishes the one in progress, then, with ``--trace 1``, profiles one more
unit and times the stages. It reads the peak memory, frees the program,
has the driver compare the outputs with the plain reference, and prints
each compared number beside its limit on standard error and, last on
standard output, one JSON line with the cell's metrics.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "certifyingfacerecognition_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from its file (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(
        "cfr_bench._loaded." + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str, bench: dict):
    """(cell, configuration, traffic) of the cell ``name``, each from its
    own file; the configuration's ``file`` is as BENCHMARK.json names it."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(CHECKOUT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def cell_metrics(bench: dict, section: str, cell: str) -> list:
    """The entries of ``section`` that the cell reports: those that list
    it, and those that list no cells when the cell reports what they
    move."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def set_environment(config: dict) -> None:
    """Build and kernel caches at fixed paths inside the checkout, and the
    configuration's own settings, before the program is imported."""
    # one process with few host threads: the program's host work is
    # launching kernels from one thread, and idle intra-op workers only
    # compete with it for the host's cores
    os.environ["OMP_NUM_THREADS"] = "1"
    build = CHECKOUT / "build"
    os.environ["CFR_KERNEL_BUILD_DIR"] = str(build / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    for key, value in config.get("env", {}).items():
        os.environ[key] = str(value)


def is_correct(checks: list) -> bool:
    """A run is correct when every compared number is within its limit."""
    return all(c["value"] <= c["limit"] for c in checks)


def window_quantity(metric: str) -> str:
    """The driver's quantity that an end-to-end metric reports: its name
    up to the first dot (``certify_samples_per_s.facenet`` is a
    configuration's own ``certify_samples_per_s``, with a bound of its
    own)."""
    return metric.split(".")[0]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Ctx:
    """What a driver is given: the run's arguments, the cell's files and
    the device."""

    def __init__(self, cell, config, traffic, seed, device, chips):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device, self.chips = seed, device, chips


def run_cell(ctx: Ctx, seconds: float, trace: bool, driver, bench: dict,
             t_start: float) -> dict:
    """Set up, measure, check: the result line (without the device-free
    checks of ``main``)."""
    import torch

    on_card = ctx.device.type == "cuda"
    state = driver.setup(ctx)
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    units = 0
    while True:
        driver.run_unit(state, units)
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    window = driver.window_metrics(state, t1 - t0)
    window["setup_s"] = setup_s

    layer, device_extra = {}, {}
    if trace:
        layer = driver.layer_record(state)
        layer.update(profile_unit(driver, state, units, on_card))
        layer.update(window)
        device_extra = {"busy_s": layer["busy_s"],
                        "window_s": layer["window_s"]}
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    driver.release(state)
    if on_card:
        torch.cuda.empty_cache()
    checks = driver.check(state)

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, section, ctx.cell["name"]):
        if trace:
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(
                layer)
        else:
            value = window.get(window_quantity(m["name"]))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": is_correct(checks),
        "attempted": state.attempted,
        "failed": driver.failed(state, checks),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(ctx.device)
                            if on_card else "cpu"),
                   "count": ctx.chips, "memory_peak_bytes": int(peak),
                   **device_extra},
    }
    if trace:
        result["breakdown"] = {"device_ops": layer["device_ops"],
                               "idle_gaps": layer["idle_gaps"]}
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]} for c in checks}
    return result


def profile_unit(driver, state, index: int, on_card: bool) -> dict:
    """One more unit under torch.profiler: busy and idle time and the
    kernels by name. Its outputs join the checked ones."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import trace as T

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        driver.run_unit(state, index)
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return T.summarise(T.events(prof), window_s)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    bench = load_json(CHECKOUT / "BENCHMARK.json")
    cell, config, traffic = cell_spec(args.workload, bench)
    set_environment(config)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    driver = load_module(HERE / "drivers" / f"{traffic['kind']}.py")
    ctx = Ctx(cell, config, traffic, args.seed, torch.device("cuda", 0),
              cell["chips"])
    result = run_cell(ctx, args.seconds, bool(args.trace), driver, bench,
                      t_start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
