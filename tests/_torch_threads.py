"""An autouse fixture that runs the port on one CPU thread for the
module that imports it.  Every port test module imports it (but
``test_torch_cuda.py``, which runs on the card, and
``test_torch_imports.py``, which computes nothing): their tensors are
small, and beside the suite's other workers more threads only contend.
On an 8-core CPU with six xdist workers, torch's default of one thread a
core made the trainer CLI's tests 15-150 times slower than alone (0.7 s
alone, 97 s in the suite), and the whole suite took 1189 s against 728 s
with one thread (``tests/_torch_lm_parity.py`` does the same inside each
trainer case)."""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
