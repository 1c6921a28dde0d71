"""One intra-op torch thread for a port test module.

The suite runs in several worker processes on one host at once (pytest
-n), each of which would otherwise start a thread per core for every
torch op: on the small tensors of the smoke configs those threads mostly
wait on each other and on the other workers.  A module imports
``one_torch_thread`` to run its tests on one thread; the count in force
before is put back after the module's last test.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
