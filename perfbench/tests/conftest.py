"""The benchmark's tests: ``python -m pytest perfbench/tests`` from the
checkout's root.  Tests marked ``cuda`` need an NVIDIA card and skip
without one (on the card: ``python -m pytest -m cuda perfbench/tests``)."""
import sys
from pathlib import Path

import pytest

PERF = Path(__file__).resolve().parents[1]
for p in (str(PERF), str(PERF.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
