"""pytest settings of the benchmark's own tests (benchmarks/tests/).

    python -m pytest benchmarks/ -q            # on the CPU; card tests skip
    python -m pytest benchmarks/ -q -m gpu     # on a machine with a card

The benchmark's packages (harness, plainref) and the port import from the
checkout. Tests that need a CUDA device take the `cuda` fixture, which
skips them where there is none; nothing decides that at import time.
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
for _p in (str(BENCH), str(BENCH.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device and skips without one; run "
        "them on the card with `python -m pytest -m gpu benchmarks/`")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
