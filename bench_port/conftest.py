"""pytest settings of the benchmark's own tests (bench_port/tests): the
`cuda` marker for tests that need the card. Whether a card is there is
decided inside the `cuda_device` fixture, never at import."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on the card only")
    return torch.device("cuda")
