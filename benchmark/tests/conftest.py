"""CPU tests of the benchmark (``python -m pytest benchmark/tests``); the
test marked ``cuda`` runs on the card and skips elsewhere."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA GPU; skipped elsewhere")
