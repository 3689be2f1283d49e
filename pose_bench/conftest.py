"""pytest settings for the benchmark's own tests (``python -m pytest pose_bench/tests``).

Tests that need a CUDA card carry the ``card`` marker and decide inside the
test whether one is present, skipping on the CPU."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
