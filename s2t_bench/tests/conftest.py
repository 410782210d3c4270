"""The benchmark's own tests (not collected by the repository's tests/).
Tests that need a CUDA card carry the `card` marker and take the `card`
fixture, which skips them where no card is present; run them on the
card with `python3 -m pytest s2t_bench/tests -m card`."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips "
                            "without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
