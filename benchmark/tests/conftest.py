"""Settings for the benchmark's own tests (`python -m pytest benchmark/tests`):
the `cuda` marker, and one intra-op thread so that they sit beside other work."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips on a machine without one")


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def gpu():
    """Skips, with the reason, where no GPU is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
