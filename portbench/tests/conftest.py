"""The benchmark's own tests (CPU; those marked `cuda` run on the card):

    python -m pytest portbench/tests -q
    python -m pytest portbench/tests -q -m cuda     # on the card
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skips without one")
