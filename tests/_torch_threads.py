"""A fixture the port's test files share: import it into a module as

    from _torch_threads import _one_torch_thread  # noqa: F401 (autouse)

and it pins torch to one intra-op thread while that module's tests run.
Their tensors are small, so one thread does the work, while the default
team of one thread a core only spins against the other test workers
(pytest-xdist's ``-n 6`` oversubscribed the host with it)."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
