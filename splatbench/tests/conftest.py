"""Fixtures of splatbench's own tests (run them with ``python -m pytest
splatbench/tests -q`` from the repository root; the card's with ``-m cuda``
on a machine that has one)."""
import pytest
import torch


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); this machine has none")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)
