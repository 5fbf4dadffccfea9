"""The benchmark's own tests: `python -m pytest gcd_bench/tests -q` on the
CPU; the tests marked `card` need a CUDA card and skip elsewhere
(`python -m pytest gcd_bench/tests -m card` on the card)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
