"""Tests of the benchmark harness.  Run from the repository root:

    python -m pytest benchmark/tests -q

Tests marked ``card`` need a CUDA card; each decides inside itself whether
one is there and skips on the CPU."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips on the CPU")
