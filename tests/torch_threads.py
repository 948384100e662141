"""The one-thread fixture of the port's slower CPU test modules: a module
imports ``one_torch_thread`` and its port calls run on one intra-op
thread."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's port calls on one intra-op thread (restored after):
    with the suite's parallel workers, each process's pool of threads
    spinning on these small tensors stalls every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
