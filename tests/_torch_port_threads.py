"""The port's CPU tests run torch on one thread: a test module imports
`_one_torch_thread`, an autouse fixture of module scope, from here."""

import pytest


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny CPU shapes gain nothing from intra-op threads, and with
    several test processes on the cores those threads oversubscribe them
    (several times slower); restored after the module."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
