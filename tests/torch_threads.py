"""The port's CPU tests run their torch ops on one intra-op thread.

Each ``tests/test_torch_*.py`` that runs torch imports the autouse
fixture.  The suite runs in several pytest-xdist worker processes on a
few cores; there a small op spread over every core waits on the other
workers' threads (measured: a 3 s test took 229 s at -n 6).  The
previous count is restored after the module."""
import pytest


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    torch = pytest.importorskip("torch")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
