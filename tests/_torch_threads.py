"""An autouse fixture that runs the port on one CPU thread for the
module that imports it: the parity tests' tensors are small, and beside
the suite's other workers more threads only contend (as
``tests/_torch_lm_parity.py`` does for the trainer cases)."""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
