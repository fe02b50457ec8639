"""One intra-op thread for the port's tests on the CPU.

The suite runs six test files side by side on the host's cores, several
of them with subprocesses of their own, and torch starts a thread a core
in every process: the pools then spin against each other, and a file
that takes seconds alone takes minutes in the suite.  The port's test
shapes are small, so one thread loses little on its own.  Test modules
import ``one_thread`` (an autouse fixture); subprocesses get
``ONE_THREAD_ENV`` in their environment."""
import pytest
import torch

ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The module runs on one intra-op thread and restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
