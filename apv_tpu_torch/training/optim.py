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

The count is a host number, and so are the learning rate and the bias
corrections that follow from it: a step never waits for the device. A
call reads them from a small float32 device tensor (``step(hyper=)``),
which the train step fills from ``hyper()``, the host's numbers of its
next calls, as it fills its other per-step inputs; a step captured in a
CUDA graph (``training/graph.py``) then reads each replay's. A call
handed none makes its own. The clip factor stays on the device.

With ``every_k = k > 1`` it is ``optax.MultiSteps(chain, every_k_schedule=k)``
(``use_grad_mean=True``): each call folds its gradients into optax's
running mean acc ← acc + (g − acc)/(n + 1), n the micro-steps already
folded in; the k-th call clips and applies Adam to that mean and zeroes
it, the k − 1 calls before it leave the parameters untouched. The count
and the schedule tick once per applied update.
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


def cosine_decay(init_value: float, decay_steps: int,
                 alpha: float = 0.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule`` as a function of the count: from
    ``init_value`` down to ``alpha``·``init_value`` at ``decay_steps``,
    constant after."""
    if decay_steps <= 0:
        raise ValueError(f"cosine_decay needs decay_steps > 0, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def constant(value: float) -> Callable[[int], float]:
    return lambda count: value


def warmup_constant(peak_value: float,
                    warmup_steps: int) -> Callable[[int], float]:
    """VDVAE's ``linear_warmup``: peak·count/warmup up to the warmup, then
    the peak."""
    return lambda count: (peak_value if count > warmup_steps
                          else peak_value * count / warmup_steps)


def own_hyper(opt, device: torch.device) -> torch.Tensor:
    """The numbers of ``opt``'s next call as a float32 tensor on
    ``device``, for a call that was handed none."""
    return torch.tensor(opt.hyper(1)[0], dtype=torch.float32).to(
        device, non_blocking=True)


def _copy_saved(opt, saved: dict, names: Sequence[str]) -> None:
    """Copy ``saved``'s lists ``names`` into ``opt``'s tensors in place, and
    its count."""
    for name in names:
        mine, theirs = getattr(opt, name), saved[name]
        if len(mine) != len(theirs) or any(
                a.shape != b.shape for a, b in zip(mine, theirs)):
            raise ValueError(f"{type(opt).__name__}: saved {name} does not "
                             "match this optimizer's parameters")
        for a, b in zip(mine, theirs):
            a.copy_(b)
    opt.count = int(saved["count"])


class ClippedAdam:
    """Global-norm clip then Adam, over ``params`` in place, with gradient
    accumulation over ``every_k`` calls (see module docstring).
    ``step(grads)`` returns the global norm of this call's gradients,
    unclipped, as a 0-dim device tensor."""

    HYPER = 3        # lr, 1 − b1^t, 1 − b2^t

    def __init__(self, params: Sequence[torch.Tensor],
                 lr: Callable[[int], float], *, clip_norm: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 every_k: int = 1):
        self.params = list(params)
        self.lr, self.clip_norm = lr, clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.every_k = every_k
        self.count = 0
        self.mini_step = 0
        self._hyper = None                  # the applying call's numbers
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if every_k > 1 else None)

    def hyper(self, calls: int = 1) -> list[list[float]]:
        """The host numbers of the next ``calls`` calls, in order: the
        learning rate and bias corrections lr(count), 1 − b1^(count+1) and
        1 − b2^(count+1) of the update each applies (a call that only
        folds its gradients in, those of the next update)."""
        out, count, mini = [], self.count, self.mini_step
        for _ in range(calls):
            out.append([self.lr(count), 1.0 - self.b1 ** (count + 1),
                        1.0 - self.b2 ** (count + 1)])
            if mini < self.every_k - 1:
                mini += 1
            else:
                mini, count = 0, count + 1
        return out

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             scales: Sequence[torch.Tensor] | None = None,
             hyper: torch.Tensor | None = None) -> torch.Tensor:
        """Fold in one call's gradients; on an applying call, update the
        parameters, each update (after Adam, the moments untouched) times
        its entry of ``scales`` when given: 0-dim device tensors, one per
        parameter, the floor-adaptive D throttle. ``hyper``: this call's
        ``hyper()`` numbers, float32 on the parameters' device. Returns
        this call's gradient norm."""
        grads = list(grads)
        self._hyper = (own_hyper(self, self.params[0].device) if hyper is None
                       else hyper)
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        if self.acc is not None:
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            if self.mini_step < self.every_k - 1:
                self.mini_step += 1
                return norm
            self.mini_step = 0
            self._apply(self.acc, torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(self.acc))), scales)
            torch._foreach_zero_(self.acc)
            return norm
        self._apply(grads, norm, scales)
        return norm

    def _apply(self, grads: list[torch.Tensor], norm: torch.Tensor,
               scales: Sequence[torch.Tensor] | None) -> None:
        """Clip by ``norm``, the global norm of ``grads``, then Adam with
        the learning rate and bias corrections of the call's ``hyper``."""
        factor = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                             self.clip_norm / norm)
        grads = torch._foreach_mul(grads, factor)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        lr, bc1, bc2 = self._hyper.unbind()
        m_hat = torch._foreach_div(self.mu, bc1)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(m_hat, denom)
        # the update −lr·u, then (optax's order) the throttle
        torch._foreach_mul_(m_hat, lr)
        if scales is not None:
            torch._foreach_mul_(m_hat, list(scales))
        torch._foreach_sub_(self.params, m_hat)
        self.count += 1

    @torch.no_grad()
    def ema_(self, ema: Sequence[torch.Tensor], decay: float) -> None:
        """e ← decay·e + (1 − decay)·θ."""
        ema = list(ema)
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, self.params, alpha=1.0 - decay)

    def tensors(self) -> list[torch.Tensor]:
        """The state's tensors: moments, then the accumulator."""
        return self.mu + self.nu + (self.acc or [])

    def state_dict(self) -> dict:
        """The update count and both moments (tensors on their device);
        with accumulation also the running mean and its micro-step."""
        out = {"count": self.count, "mu": list(self.mu),
               "nu": list(self.nu)}
        if self.acc is not None:
            out.update(acc=list(self.acc), mini_step=self.mini_step)
        return out

    @torch.no_grad()
    def load_state_dict(self, saved: dict) -> None:
        """Copy a ``state_dict`` into this optimizer's moments in place. A
        saved accumulator is read only by an optimizer that accumulates;
        one that accumulates starts a fresh window from a state saved
        without one."""
        _copy_saved(self, saved, ("mu", "nu") + (
            ("acc",) if self.acc is not None and "acc" in saved else ()))
        if self.acc is not None:
            if "acc" not in saved:
                for a in self.acc:
                    a.zero_()
            mini = int(saved.get("mini_step", 0))
            if mini >= self.every_k:
                raise ValueError(f"ClippedAdam: saved micro-step {mini} is "
                                 f"past this optimizer's window of "
                                 f"{self.every_k}")
            self.mini_step = mini


class SkippingAdamW:
    """VDVAE's update (``train.py`` of github.com/openai/vdvae): the global
    norm n of the gradients; each scaled by min(1, c/(n + 1e-6)) (PyTorch's
    ``clip_grad_norm_``); then ``torch.optim.AdamW``'s step, decoupled
    weight decay p ← p·(1 − lr·wd) first, unless n ≥ ``skip_threshold``
    or a loss term is NaN. The defaults are the published CIFAR-10
    setting's (wd 0.01, threshold 400). A skipped update leaves the parameters, both
    moments, the update count and the Polyak average (``ema_``) as they
    were.

    The test is made on the device, so no step waits for it: the update is
    PyTorch's fused AdamW kernel, which reads the count of applied updates
    (its bias corrections) from a device tensor and returns untouched when
    its ``found_inf`` flag is set. The learning rate's schedule reads
    ``count``, the host's count of calls (iterations), as the published
    scheduler steps on every iteration, skipped or not. ``applied`` (the
    device count of applied updates) and ``skipped`` (of skipped ones)
    are part of the state. ``step(grads, terms)`` returns the unclipped
    norm, a 0-dim device tensor; ``hyper`` is the call's learning rate,
    as ``ClippedAdam``'s (module docstring)."""

    HYPER = 1        # lr

    def __init__(self, params: Sequence[torch.Tensor],
                 lr: Callable[[int], float], *, clip_norm: float,
                 skip_threshold: float = 400.0, weight_decay: float = 0.01,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.clip_norm = lr, clip_norm
        self.skip_threshold, self.weight_decay = skip_threshold, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mini_step, self.acc = 0, None      # no accumulation
        dev = self.params[0].device
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.applied = torch.zeros((), dtype=torch.float32, device=dev)
        self.skipped = torch.zeros((), dtype=torch.float32, device=dev)
        self.skip = torch.zeros((), dtype=torch.float32, device=dev)

    def hyper(self, calls: int = 1) -> list[list[float]]:
        """The learning rates lr(count) of the next ``calls`` calls."""
        return [[self.lr(self.count + i)] for i in range(calls)]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             terms: Sequence[torch.Tensor] = (),
             hyper: torch.Tensor | None = None) -> torch.Tensor:
        """Clip, test and (unless skipped) update; ``terms`` are the loss
        terms whose NaN skips the update; ``hyper`` this call's
        ``hyper()``, float32 on the parameters' device."""
        if hyper is None:
            hyper = own_hyper(self, self.params[0].device)
        # the fused update takes each gradient in its parameter's strides
        grads = [g if g.stride() == p.stride() else
                 torch.empty_like(p).copy_(g)
                 for g, p in zip(grads, self.params)]
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        factor = torch.clamp(self.clip_norm / (norm + 1e-6), max=1.0)
        torch._foreach_mul_(grads, factor)
        ok = norm < self.skip_threshold
        for t in terms:
            ok = ok & ~torch.isnan(t)
        torch.sub(1.0, ok.to(torch.float32), out=self.skip)
        self.applied.add_(1.0 - self.skip)
        self.skipped.add_(self.skip)
        # the count of applied updates, read by every parameter's update
        steps = [self.applied] * len(self.params)
        torch._fused_adamw_(
            self.params, grads, self.mu, self.nu, [], steps,
            lr=hyper[0], beta1=self.b1, beta2=self.b2,
            weight_decay=self.weight_decay, eps=self.eps, amsgrad=False,
            maximize=False, found_inf=self.skip)
        self.count += 1
        return norm

    @torch.no_grad()
    def ema_(self, ema: Sequence[torch.Tensor], decay: float) -> None:
        """e ← e + (1 − decay)·(θ − e) after an applied update; e as it
        was after a skipped one."""
        ema = list(ema)
        delta = torch._foreach_sub(self.params, ema)
        torch._foreach_mul_(delta, (1.0 - self.skip) * (1.0 - decay))
        torch._foreach_add_(ema, delta)

    def tensors(self) -> list[torch.Tensor]:
        return self.mu + self.nu + [self.applied, self.skipped]

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": list(self.mu),
                "nu": list(self.nu), "applied": self.applied,
                "skipped": self.skipped}

    @torch.no_grad()
    def load_state_dict(self, saved: dict) -> None:
        """Copy a ``state_dict`` in place; a state saved without the device
        counts (``ClippedAdam``'s) applied every update it counted."""
        _copy_saved(self, saved, ("mu", "nu"))
        self.applied.fill_(float(saved.get("applied", self.count)))
        self.skipped.fill_(float(saved.get("skipped", 0.0)))
