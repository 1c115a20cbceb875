"""The harness's tests. Tests marked `card` need an NVIDIA card and skip
elsewhere; the `card` fixture decides, when the test runs."""
from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips where there is none)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark at a size the CPU runs in seconds."""
    from portbench.tests.tiny import make_root
    return make_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
