"""Build and load the hand-written CUDA kernels of this package.

The sources under ``certifyingfacerecognition_torch/csrc/`` are compiled
with ``nvcc`` for sm_90a into a shared library with a plain C interface
and loaded with ``ctypes``. The build happens at first use, into
``build/kernels/`` at the repository root (override with
``CFR_KERNEL_BUILD_DIR``), and is keyed by a hash of the source, so an
edited source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = {"synthesis_tail_bc": CSRC / "synthesis_tail_bc.cu"}

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each C entry point: every pointer and the stream as c_void_p
# (a bare Python int would be passed as a 32-bit int and cut the pointer).
_SIGNATURES = {
    "synthesis_tail_bc": {
        "cfr_up_fused": [_I, _P, _P, _P, _P, _P, _P] + [_I] * 6 + [_P],
        "cfr_conv_fused": [_I, _P, _P, _P, _P, _P, _P] + [_I] * 6 + [_P],
        "cfr_final_stats": [_I, _P, _P, _P, _P, _P] + [_I] * 6 + [_P],
        "cfr_final_apply": [_I, _P, _P, _P, _P, _P, _P, _P, _P] + [_I] * 6
        + [_P],
    },
}

_LIBS: dict = {}
BUILD_LOG: dict = {}


def build_dir() -> Path:
    env = os.environ.get("CFR_KERNEL_BUILD_DIR")
    return Path(env) if env else _PKG.parent / "build" / "kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or put nvcc on PATH)")


def build(name: str) -> Path:
    """Compile SOURCES[name] into build_dir() unless an up-to-date library
    is there already. Returns the library path; raises on a failed build."""
    src = SOURCES[name]
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = build_dir() / f"{name}-{tag}.so"
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                       "cmd": " ".join(cmd),
                       "log": proc.stdout + proc.stderr}
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]
