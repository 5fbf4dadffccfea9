"""A module-scoped autouse fixture that runs a test file's PyTorch work on
one intra-op thread. The test workers share the host's cores, and
PyTorch's thread pool oversubscribed by them slows small ops several times
over. Use it by importing it into the test module:

    from tests.torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
