"""The benchmark's tests import cfr_bench and the program from the root
of the checkout."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
