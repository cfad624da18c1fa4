"""Chunk artifact IO (a copy of certifyingfacerecognition_tpu/eval/
artifacts.py, same file formats): per-chunk ``results_chunk{K}of{N}.npz``
(deltas/successes/magnitudes of the successful samples; the reference's
``.pth`` files are read too) and a text log of
``successes:/instances:/avg_mags:`` lines.
"""

from __future__ import annotations

import glob
import os.path as osp
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.logger import print_to_log


def save_chunk_results(results: Dict, deltas: np.ndarray,
                       successes: np.ndarray, magnitudes: np.ndarray,
                       num_chunk: int, chunks: int, results_dir: str,
                       logs_dir: str) -> Tuple[str, Optional[str]]:
    """Persist one chunk's outputs (gen_utils.py:413-437). Only successful
    deltas are stored. Returns (log_file, data_file_or_None)."""
    filename = f"results_chunk{num_chunk}of{chunks}"
    data_file = None
    if successes.sum() != 0:
        data_file = osp.join(results_dir, f"{filename}.npz")
        np.savez(data_file,
                 deltas=np.asarray(deltas)[successes],
                 successes=np.nonzero(successes)[0],
                 magnitudes=np.asarray(magnitudes)[successes])

    log_file = osp.join(logs_dir, f"{filename}.txt")
    info = "\n".join(f"{k}:{v}" for k, v in results.items())
    print_to_log(info, log_file)
    return log_file, data_file


def parse_chunk_log(log_file: str) -> Dict[str, float]:
    """Parse a results_chunk*.txt log (gen_utils.py:530-539)."""
    with open(log_file) as f:
        lines = [line.strip() for line in f if line.strip()]
    return {line.split(":")[0]: float(line.split(":")[1]) for line in lines}


def load_chunk_data(data_file: str) -> Dict[str, np.ndarray]:
    """Load a chunk data file (.npz, or the reference's .pth)."""
    if data_file.endswith(".npz"):
        with np.load(data_file) as z:
            return {k: z[k] for k in z.files}
    data = torch.load(data_file, map_location="cpu")
    return {k: np.asarray(v) for k, v in data.items()}


def find_chunk_files(results_dir: str, logs_dir: str
                     ) -> Tuple[List[str], List[str]]:
    logs = sorted(glob.glob(osp.join(logs_dir, "results_chunk*of*.txt")))
    data = sorted(glob.glob(osp.join(results_dir, "results_chunk*of*.npz")))
    if not data:
        data = sorted(glob.glob(osp.join(results_dir, "results_chunk*of*.pth")))
    return logs, data
