"""CPU tests of the benchmark (run them with `python3 -m pytest
taxbench/tests -q` from the repository's root; the repository's own
`pytest tests/` does not collect them).  Tests that need a card are marked
`cuda` and decide inside the test whether there is one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")
