"""The benchmark's own tests: CPU only, at tiny sizes.

    python3 -m pytest gpubench/tests -q

They import the harness from the checkout's root and drive it around the
port's plain CPU paths (``run.run_cell(..., device="cpu", size=...)``).
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "requires_cuda: needs a CUDA card and nvcc; skips where torch sees no card")
