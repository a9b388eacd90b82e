"""Shared pieces of the benchmark's tests. They run on the CPU at small
sizes; tests marked ``card`` need a CUDA card and skip without one:

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# The cells at a size a test run holds: every width and batch cut.
TINY = {"model": {"widths": [8, 16], "blocks_per_stage": 1, "z_dim": 8,
                  "dense": 32},
        "adversarial": {"d_widths": [16, 16]},
        "train": {"batch_size": 16, "steps_per_call": 2, "log_every": 4},
        "eval": {"iwae_k": 20, "iwae_chunk": 5, "batch_size": 8}}
TINY_WORK = {"train_loop": {"params": {"train_images": 256}},
             "evaluate_nll": {"params": {"test_images": 160,
                                         "check_images": 6}}}
CELLS = ("cifar_advprior_resnet.train_b256", "iwae_eval.k1000_b64",
         "mnist_advprior.iwae_k1000_b64")


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, when
    the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the cell's own size on "
                    "the card")
    return torch.device("cuda")
