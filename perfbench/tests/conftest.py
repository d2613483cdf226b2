"""Tests of the benchmark's own code, on the CPU at small sizes. A test that
needs a CUDA card carries the ``card`` marker and decides inside the test
whether there is one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")
