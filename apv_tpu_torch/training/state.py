"""Training state (counterpart of ``apv_tpu/training/state.py``).

One object carries what a run needs: the VAE and its optimizer, the D and
its optimizer (None for a non-adversarial run; under the biadversarial
variant the D is the ``ModuleDict`` of the latent and the pixel D, one
optimizer over both), the step count, and the seed that every step's
noise derives from together with the step (the reference's base key with
``fold_in(rng, step)``), and with ``train.ema_decay > 0`` the VAE's
Polyak average, a second module (``ema_model``) that the eval-side entry
points read (``api._p``). Unlike the reference's immutable pytree, the
modules and optimizer moments are updated in place by ``train_step``;
``state_dict`` and ``load_state_dict`` are what a checkpoint saves and
restores (``utils/checkpoint.py``).

Restoring across EMA configs follows the reference
(``apv_tpu/utils/checkpoint.py``): a saved shadow is dropped by a state
without one (the raw parameters are then used), and a state with a shadow
seeds it from the restored parameters when the checkpoint has none (one
saved under ``ema_decay=0``, or before the shadow existed).
"""

from __future__ import annotations

import dataclasses

import torch.nn as nn

from apv_tpu_torch.training.optim import ClippedAdam, SkippingAdamW


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module                   # VAE (encoder + decoder)
    opt: ClippedAdam | SkippingAdamW
    d: nn.Module | None                # latent D, or {latent, pixel}; or None
    d_opt: ClippedAdam | None
    seed: int                          # per-step noise = f(seed, step)
    ema_model: nn.Module | None = None  # Polyak average of model, or None

    def state_dict(self) -> dict:
        """Everything a run resumes from: the step, the seed, the VAE's and
        D's parameters, both optimizers' moments, counts and accumulators,
        and the EMA shadow."""
        out = {"step": self.step, "seed": self.seed,
               "model": self.model.state_dict(),
               "opt": self.opt.state_dict()}
        if self.d is not None:
            out.update(d=self.d.state_dict(), d_opt=self.d_opt.state_dict())
        if self.ema_model is not None:
            out["ema_model"] = self.ema_model.state_dict()
        return out

    def tensors(self) -> list:
        """Every tensor of the state, in one order: the parameters and
        buffers of the VAE, D and the EMA shadow, then both optimizers'
        moments and accumulators (and the skipping optimizer's device
        counts; the tensors share storage with the state's)."""
        mods = [m for m in (self.model, self.d, self.ema_model)
                if m is not None]
        out = [t for m in mods for t in m.state_dict().values()]
        for o in (self.opt, self.d_opt):
            if o is not None:
                out += o.tensors()
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
        if self.ema_model is not None:
            self.ema_model.load_state_dict(saved.get("ema_model",
                                                     saved["model"]))
        self.step, self.seed = int(saved["step"]), int(saved["seed"])

