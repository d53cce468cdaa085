"""Fixtures of the benchmark's own tests (run with ``python -m pytest
benchmark/tests`` from the repository's root)."""

import pytest
import torch


@pytest.fixture
def cuda_card():
    """Skips a test that needs the card where there is none; decided here,
    inside the fixture, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
