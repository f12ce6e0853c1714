"""pytest settings of the benchmark's tests: the program importable, and
the marker of the tests that need a CUDA card (they skip here)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA card; run on the card with `python -m pytest -m gpu perfbench`")


@pytest.fixture()
def cuda_card():
    """The card, or a skip where there is none (decided when the test runs)."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
