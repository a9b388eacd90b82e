"""Training state (counterpart of ``apv_tpu/training/state.py``).

One object carries what a run needs: the VAE and its optimizer, the D and
its optimizer (None for a non-adversarial run; under the biadversarial
variant the D is the ``ModuleDict`` of the latent and the pixel D, one
optimizer over both), the step count, and
the seed that every step's noise derives from together with the step
(the reference's base key with ``fold_in(rng, step)``). Unlike the
reference's immutable pytree, the modules and optimizer moments are
updated in place by ``train_step``; ``state_dict`` and ``load_state_dict``
are what a checkpoint saves and restores (``utils/checkpoint.py``).
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
    d: nn.Module | None                # latent D, or {latent, pixel}; or None
    d_opt: ClippedAdam | None
    seed: int                          # per-step noise = f(seed, step)

    def state_dict(self) -> dict:
        """Everything a run resumes from: the step, the seed, the VAE's and
        D's parameters and both optimizers' moments and counts."""
        out = {"step": self.step, "seed": self.seed,
               "model": self.model.state_dict(),
               "opt": self.opt.state_dict()}
        if self.d is not None:
            out.update(d=self.d.state_dict(), d_opt=self.d_opt.state_dict())
        return out

    def load_state_dict(self, saved: dict) -> None:
        """Copy a ``state_dict`` into this state's tensors in place."""
        if (self.d is None) != ("d" not in saved):
            raise ValueError("TrainState: the saved state and this one "
                             "disagree on whether there is a latent D")
        self.model.load_state_dict(saved["model"])
        self.opt.load_state_dict(saved["opt"])
        if self.d is not None:
            self.d.load_state_dict(saved["d"])
            self.d_opt.load_state_dict(saved["d_opt"])
        self.step, self.seed = int(saved["step"]), int(saved["seed"])
