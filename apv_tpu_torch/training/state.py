"""Training state (counterpart of ``apv_tpu/training/state.py``).

One object carries what a run needs: the VAE and its optimizer, the latent
D and its optimizer (None for a non-adversarial run), the step count, and
the seed that every step's noise derives from together with the step
(the reference's base key with ``fold_in(rng, step)``). Unlike the
reference's immutable pytree, the modules and optimizer moments are
updated in place by ``train_step``.
"""

from __future__ import annotations

import dataclasses

import torch.nn as nn

from apv_tpu_torch.training.optim import ClippedAdam


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module                   # VAE (encoder + decoder)
    opt: ClippedAdam
    d: nn.Module | None                # latent discriminator (None if unused)
    d_opt: ClippedAdam | None
    seed: int                          # per-step noise = f(seed, step)
