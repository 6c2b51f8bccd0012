"""One torch thread per test module: every ``tests/test_torch_*.py`` imports
:func:`one_thread`, an autouse fixture.

The port's tests run small ops, and under ``pytest -n 6`` six workers share
the machine's cores: each worker's full intra-op thread pool then spends
more on its barriers than the threads save (on an 8-core machine, six
copies of ``test_torch_package.py`` at once ran past 300 s each with the
default pools and take ~25 s with one thread).  A test's CLI subprocess
starts its own pool: give it ``OMP_NUM_THREADS=1``.
"""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
