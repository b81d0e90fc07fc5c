"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the repository root (CPU; the ``cuda``-marked ones run on the card)."""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

torch.set_num_threads(2)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is found (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
