"""The benchmark's own tests: CPU, tiny sizes; card tests are marked
`cuda` and skip where there is no card.

    python -m pytest mvbench/tests -q        (from the checkout's root)
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where "
        "torch.cuda.is_available() is False")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
