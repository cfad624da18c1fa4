"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""

import ast
import json
import re
from pathlib import Path

import pytest

from cfr_bench import harness

BENCH = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cfr_bench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("cfr_bench/") and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])


def test_bounds_and_end_to_end():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_what_its_layers_move(cell):
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, "end_to_end",
                                                   cell)]
    layer = harness.cell_metrics(BENCH, "per_layer", cell)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m["moves"] in e2e for m in layer)


def test_layers_of_one_name_spell_it_alike():
    seen = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        seen.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in seen.values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_harness_finds_every_file_by_name(cell):
    spec, config, traffic = harness.cell_spec(cell, BENCH)
    assert config["name"] == spec["config"]
    driver = harness.load_module(harness.HERE / "drivers"
                                 / f"{traffic['kind']}.py")
    for fn in ("setup", "run_unit", "window_metrics", "layer_record",
               "release", "check", "failed"):
        assert callable(getattr(driver, fn))
    limits = config["limits"][traffic["kind"]]
    assert all(v >= 0 for v in limits.values())
    for m in harness.cell_metrics(BENCH, "per_layer", cell):
        mod = harness.load_module(harness.HERE / "metrics"
                                  / f"{m['name']}.py")
        assert callable(mod.read)


def test_configs_are_each_their_own_file():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        data = harness.load_json(harness.CHECKOUT / c["file"])
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["dtype"] == "bf16" and data["resolution"] == 1024


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


REFERENCE = sorted((harness.HERE / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCE, ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    banned = {"jax", "jaxlib", "flax", "certifyingfacerecognition_tpu",
              "certifyingfacerecognition_torch"}
    assert not set(_imports(path)) & banned


def test_nothing_in_the_benchmark_imports_jax():
    banned = {"jax", "jaxlib", "flax", "certifyingfacerecognition_tpu"}
    for path in harness.HERE.rglob("*.py"):
        assert not set(_imports(path)) & banned, path


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_widths_are_those_the_reference_builds(entry):
    from cfr_bench import families
    from cfr_bench.reference import pipeline as ref

    data = harness.load_json(harness.CHECKOUT / entry["file"])
    gen, frm = families.of(data)
    ref.check_widths(data, gen, frm)
    with pytest.raises(ValueError, match="channels_min"):
        ref.check_widths(dict(data, channels_min=2 * data["channels_min"]),
                         gen, frm)
