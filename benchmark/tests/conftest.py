import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small tensors in many processes: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
