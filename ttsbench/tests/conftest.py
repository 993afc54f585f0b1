"""The benchmark's own tests: `python -m pytest ttsbench/tests -q`. Those
marked `card` need a CUDA device and skip without one; on the card:
`python -m pytest ttsbench/tests -q -m card`."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
