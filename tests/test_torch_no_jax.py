"""The PyTorch package and chip_smoke.py import neither JAX nor anything of
the JAX package, nor PIL or scikit-learn, which the card's machine does not
have (AST scan of every import statement)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "certifyingfacerecognition_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "certifyingfacerecognition_tpu", "PIL", "sklearn")
# The attack CLI's adversary figures (the JAX package's .jpg files) use PIL
# where it is installed and are skipped where it is not.
OPTIONAL = {"chunk_runner.py": ("PIL",)}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED
           and m.split(".")[0] not in OPTIONAL.get(path.name, ())]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_covers_the_port():
    names = {p.name for p in FILES}
    assert {"chip_smoke.py", "synthesis_tail_bc.py", "certify.py",
            "stylegan.py", "main_attack.py", "pgd.py", "geometry.py",
            "pggan.py", "generate_data.py", "manipulator.py", "png.py",
            "mesh.py", "gallery.py", "profiling.py", "tail_kernel_bench.py",
            "gallery_bench.py", "pkl_converter.py", "validate_conversion.py",
            "certified_curve.py", "adaptive_study.py", "resolution_study.py",
            "spectral_study.py", "mix_study.py", "coverage_sweep.py",
            "weak_scaling.py", "bench.py"} <= names
    assert ROOT / "certifyingfacerecognition_torch" / "tools" / \
        "pkl_converter.py" in FILES
    assert ROOT / "certifyingfacerecognition_torch" / "bench.py" in FILES
