"""The optimizers of the train step, written to optax's formulas
(counterpart of the ``optax`` chains in ``apv_tpu/training/step.py``).

``ClippedAdam`` is ``optax.chain(clip_by_global_norm(c), adam(lr, b1, b2,
eps))`` applied in place:

* clip: with n the global norm of the gradients, each gradient becomes
  (g / n)·c when n ≥ c (optax's order of operations; no +1e-6 as in
  ``torch.nn.utils.clip_grad_norm_``);
* Adam: m ← b1·m + (1−b1)·g, v ← b2·v + (1−b2)·g², then the update
  −lr(count)·m̂/(√v̂ + eps) with m̂ = m/(1−b1^(count+1)) and
  v̂ = v/(1−b2^(count+1)); the learning rate is read at the count before
  its increment, as ``scale_by_learning_rate`` reads its schedule.

The count, the learning rate and the bias corrections are host numbers,
so a step never waits for the device; the clip factor stays on the device.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule`` as a function of the count:
    linear from ``init_value`` to ``peak_value`` over ``warmup_steps``, then
    cosine decay to ``end_value`` at ``decay_steps`` (which includes the
    warmup), constant after."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if warmup_steps <= 0 or cos_steps <= 0:
        raise ValueError(f"warmup_steps={warmup_steps} and decay_steps="
                         f"{decay_steps} must satisfy 0 < warmup < decay")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def constant(value: float) -> Callable[[int], float]:
    return lambda count: value


class ClippedAdam:
    """Global-norm clip then Adam, over ``params`` in place (see module
    docstring). ``step(grads)`` returns the unclipped global norm as a
    0-dim device tensor."""

    def __init__(self, params: Sequence[torch.Tensor],
                 lr: Callable[[int], float], *, clip_norm: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.clip_norm = lr, clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        grads = list(grads)
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        factor = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                             self.clip_norm / norm)
        grads = torch._foreach_mul(grads, factor)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        t = self.count + 1
        m_hat = torch._foreach_div(self.mu, 1.0 - self.b1 ** t)
        denom = torch._foreach_div(self.nu, 1.0 - self.b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(m_hat, denom)
        torch._foreach_add_(self.params, m_hat, alpha=-self.lr(self.count))
        self.count = t
        return norm

    def state_dict(self) -> dict:
        """The update count and both moments (tensors on their device)."""
        return {"count": self.count, "mu": list(self.mu),
                "nu": list(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, saved: dict) -> None:
        """Copy a ``state_dict`` into this optimizer's moments in place."""
        for name in ("mu", "nu"):
            mine, theirs = getattr(self, name), saved[name]
            if len(mine) != len(theirs) or any(
                    a.shape != b.shape for a, b in zip(mine, theirs)):
                raise ValueError(f"ClippedAdam: saved {name} does not match "
                                 "this optimizer's parameters")
            for a, b in zip(mine, theirs):
                a.copy_(b)
        self.count = int(saved["count"])
