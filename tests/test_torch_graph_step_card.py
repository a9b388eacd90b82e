"""The train step captured in a CUDA graph (``training/graph.py``) against
the eager step, on the card.

Each test needs a CUDA card and skips without one; this file imports no
JAX, so on the card's machine it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -m card \\
        tests/test_torch_graph_step_card.py

From one state at step 10 (inside β's and the learning rates'
warm-ups, where a frozen number would show), 11 steps eagerly and 11
through ``StepRunner`` (its first eager, the 10 after it replayed), under
deterministic cuDNN (``chip_smoke.graph_pair``): every tensor of the
state (parameters, both optimizers' moments, ``SkippingAdamW``'s
``applied`` and ``skipped``, the EMA), the host counts, every metric of
every step and the kernel wrappers' launch and route counts must be the
same bits. The flagship preset, MNIST config 2, the IWAE-5 objective and
VDVAE, each at its preset's full size, and VDVAE with a NaN planted in
its decoder's gain, so that every update skips.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CASES = {"flagship": ("cifar_advprior_resnet", []),
         "mnist": ("mnist_advprior", []),
         "iwae5": ("cifar_advprior_resnet", ["train.objective=iwae",
                                             "train.iwae_k=5"]),
         "vdvae": ("vdvae_cifar10", [])}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: a CUDA graph is captured only there")
    return torch.device("cuda")


def _nan_gain(state):
    with torch.no_grad():
        state.model.decoder.gain[0, 0] = float("nan")


@pytest.mark.card
@pytest.mark.parametrize("case,plant", [
    ("flagship", None), ("mnist", None), ("iwae5", None), ("vdvae", None),
    ("vdvae", "nan")])
def test_card_replayed_steps_equal_eager_steps(card, case, plant):
    from apv_tpu_torch import apply_overrides, get_preset
    preset, sets = CASES[case]
    cfg = apply_overrides(get_preset(preset), ["train.steps=100000", *sets])
    got = chip_smoke.graph_pair(cfg, card, 10,
                                plant=_nan_gain if plant else None)
    assert got["launches_equal"] and got["launches"]["reparam"] > 0, got
    assert got["bits_equal"], got
    if plant:
        assert got["skipped"] == [11.0, 11.0], got
    elif got["skipped"] is not None:
        assert got["skipped"] == [0.0, 0.0], got
