"""pytest settings of the benchmark's own tests (``posebench/tests``).

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them where CUDA is not available; the decision is
made when the test runs, never when a module is imported.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (run on the card: "
        "python3 -m pytest posebench/tests -m card)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
