"""RealNVP affine-coupling flow on z (counterpart of ``apv_tpu/core/flow.py``).

Pure functions over a dict of tensors ``{"whiten": {"mean", "log_std"},
"layers": [{"w1", "b1", "w2", "b2", "w3", "b3"}, ...]}``: the ex-post flow
prior (``sampling/run.expost_prior_flow``) is such a dict, and the trained
flow prior (``models/flow_prior.py``) holds one as its parameters.

* Every coupling MLP's last layer starts at zero, so the flow starts as
  the identity.
* The log-scale is smoothly capped, s = 3·tanh(raw/3).
* A whitening layer (``mean``, ``log_std``) takes q(z)'s per-dim spread,
  so the couplings model shape, not scale.

``fit_flow`` is the maximum-likelihood fit: AdamW (optax's formulas) over
a cosine-decayed learning rate, keeping the parameters of the best
holdout NLL. The selection is ``torch.where`` on the device, so the fit
never waits for a host read. Its draws come from a ``torch.Generator`` or
are injected (the tests hand in JAX's).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_SCALE_CAP = 3.0
_LOG_2PI = math.log(2.0 * math.pi)


def _mask(z_dim: int, layer: int, device=None) -> torch.Tensor:
    """Alternating binary mask; 1 = conditioning (pass-through) dims."""
    return ((torch.arange(z_dim, device=device) + layer) % 2).to(torch.float32)


def init_flow(z_dim: int, *, n_layers: int = 6, hidden: int = 64,
              mean=None, std=None, generator: torch.Generator | None = None,
              draws=None, device=None) -> dict:
    """Flow params that map z to itself until fitted.

    The hidden layers are He-normal: ``draws`` gives each layer's two
    standard-normal draws ``(n1 [Z, H], n2 [H, H])``, else they come from
    ``generator``. ``mean``/``std`` ([Z] each) seed the whitening layer,
    0 and 1 by default."""
    if n_layers < 2:
        raise ValueError(f"a flow needs n_layers >= 2 so every dim is "
                         f"transformed at least once, got {n_layers}")
    dev = torch.device(device) if device is not None else (
        generator.device if generator is not None else torch.device("cpu"))
    f32 = dict(dtype=torch.float32, device=dev)
    layers = []
    for i in range(n_layers):
        if draws is not None:
            n1, n2 = (torch.as_tensor(d).to(**f32) for d in draws[i])
        else:
            n1 = torch.randn((z_dim, hidden), generator=generator, **f32)
            n2 = torch.randn((hidden, hidden), generator=generator, **f32)
        layers.append({
            "w1": n1 * math.sqrt(2.0 / z_dim),
            "b1": torch.zeros(hidden, **f32),
            "w2": n2 * math.sqrt(2.0 / hidden),
            "b2": torch.zeros(hidden, **f32),
            "w3": torch.zeros((hidden, 2 * z_dim), **f32),
            "b3": torch.zeros(2 * z_dim, **f32),
        })
    return {
        "whiten": {
            "mean": (torch.zeros(z_dim, **f32) if mean is None
                     else torch.as_tensor(mean).to(**f32)),
            "log_std": (torch.zeros(z_dim, **f32) if std is None
                        else torch.log(torch.as_tensor(std).to(**f32))),
        },
        "layers": layers,
    }


def _coupling_st(layer, z_masked: torch.Tensor, mask: torch.Tensor):
    """Coupling MLP: masked input -> (log-scale s, shift t), both zero on
    the conditioning dims."""
    h = F.silu(z_masked @ layer["w1"] + layer["b1"])
    h = F.silu(h @ layer["w2"] + layer["b2"])
    out = h @ layer["w3"] + layer["b3"]
    z_dim = mask.shape[0]
    s_raw, t = out[..., :z_dim], out[..., z_dim:]
    s = _SCALE_CAP * torch.tanh(s_raw / _SCALE_CAP)
    return s * (1.0 - mask), t * (1.0 - mask)


def flow_forward(params, z: torch.Tensor):
    """Density direction z -> u: whiten, then the couplings in order.
    Returns ``(u, log_det)``, log_det = log|det du/dz| of shape
    ``z.shape[:-1]``."""
    w = params["whiten"]
    z = z.to(torch.float32)
    u = (z - w["mean"]) * torch.exp(-w["log_std"])
    log_det = (-torch.sum(w["log_std"])).expand(z.shape[:-1])
    z_dim = z.shape[-1]
    for i, layer in enumerate(params["layers"]):
        mask = _mask(z_dim, i, z.device)
        s, t = _coupling_st(layer, u * mask, mask)
        u = mask * u + (1.0 - mask) * (u * torch.exp(s) + t)
        log_det = log_det + torch.sum(s, dim=-1)
    return u, log_det


def flow_inverse(params, u: torch.Tensor) -> torch.Tensor:
    """Sampling direction u -> z: the couplings inverted in reverse, then
    unwhitened; exact."""
    u = u.to(torch.float32)
    z_dim = u.shape[-1]
    z = u
    layers = params["layers"]
    for i in reversed(range(len(layers))):
        mask = _mask(z_dim, i, u.device)
        s, t = _coupling_st(layers[i], z * mask, mask)
        z = mask * z + (1.0 - mask) * ((z - t) * torch.exp(-s))
    w = params["whiten"]
    return z * torch.exp(w["log_std"]) + w["mean"]


def flow_logpdf(params, z: torch.Tensor) -> torch.Tensor:
    """Exact log p(z) by change of variables, shape ``z.shape[:-1]``."""
    u, log_det = flow_forward(params, z)
    log_base = -0.5 * torch.sum(u * u + _LOG_2PI, dim=-1)
    return log_base + log_det


def flow_leaves(params) -> list[torch.Tensor]:
    """The params dict's tensors in a fixed order: whitening, then each
    layer's w1, b1, w2, b2, w3, b3."""
    out = [params["whiten"]["mean"], params["whiten"]["log_std"]]
    for layer in params["layers"]:
        out += [layer[k] for k in ("w1", "b1", "w2", "b2", "w3", "b3")]
    return out


def flow_from_leaves(leaves, n_layers: int) -> dict:
    """Inverse of ``flow_leaves``."""
    names = ("w1", "b1", "w2", "b2", "w3", "b3")
    layers = [dict(zip(names, leaves[2 + 6 * i:8 + 6 * i]))
              for i in range(n_layers)]
    return {"whiten": {"mean": leaves[0], "log_std": leaves[1]},
            "layers": layers}


def fit_flow(z: torch.Tensor, *, n_layers: int = 6, hidden: int = 64,
             steps: int = 2000, batch: int = 1024, lr: float = 1e-3,
             weight_decay: float = 1e-4, holdout_frac: float = 0.1,
             generator: torch.Generator | None = None,
             perm: torch.Tensor | None = None, init_draws=None,
             indices: torch.Tensor | None = None):
    """Maximum-likelihood fit of a flow to latent samples ``z [N, Z]``.

    AdamW over ``steps`` minibatch NLL steps, learning rate
    ``lr``·½(1 + cos(π·t/steps)), decoupled weight decay added to the Adam
    direction and scaled by the learning rate (``optax.adamw``). The first
    ``holdout_frac`` of the shuffled samples never train: after every step
    they are scored and the best-scoring params are kept, so the result is
    the early-stopped flow, not the last iterate.

    Draws (from ``generator`` unless injected): ``perm`` [N] the shuffle,
    ``init_draws`` ``init_flow``'s, ``indices`` [steps, batch] the
    minibatch rows. Returns ``(params, nll_trace [steps])``, the trace the
    mean train NLL (nats) of each step, on z's device.
    """
    z = z.detach().to(torch.float32)
    n_total, z_dim = z.shape
    dev = z.device
    n_hold = int(n_total * holdout_frac)
    if n_hold > 0:
        if perm is None:
            perm = torch.randperm(n_total, generator=generator, device=dev)
        z = z[perm.to(dev)]
    z_hold, z_train = z[:n_hold], z[n_hold:]
    n = n_total - n_hold
    batch = min(batch, n)
    params = init_flow(z_dim, n_layers=n_layers, hidden=hidden,
                       mean=z_train.mean(dim=0),
                       std=z_train.std(dim=0, unbiased=False) + 1e-4,
                       generator=generator, draws=init_draws, device=dev)
    p = [t.clone().requires_grad_(True) for t in flow_leaves(params)]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    best_p = [t.detach().clone() for t in p]
    best_nll = torch.full((), float("inf"), device=dev)
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses = []
    for step in range(steps):
        idx = (indices[step].to(dev) if indices is not None else
               torch.randint(0, n, (batch,), generator=generator,
                             device=dev))
        loss = -flow_logpdf(flow_from_leaves(p, n_layers),
                            z_train[idx]).mean()
        grads = torch.autograd.grad(loss, p)
        losses.append(loss.detach())
        count = step + 1
        rate = lr * 0.5 * (1.0 + math.cos(math.pi * min(step, steps)
                                          / steps))
        with torch.no_grad():
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            upd = torch._foreach_div(mu, 1.0 - b1 ** count)
            den = torch._foreach_div(nu, 1.0 - b2 ** count)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(upd, den)
            torch._foreach_add_(upd, p, alpha=weight_decay)
            torch._foreach_add_(p, upd, alpha=-rate)
            if n_hold > 0:
                h = -flow_logpdf(flow_from_leaves(p, n_layers),
                                 z_hold).mean()
                better = h < best_nll
                best_nll = torch.where(better, h, best_nll)
                best_p = [torch.where(better, new, old)
                          for new, old in zip(p, best_p)]
            else:
                best_p = [t.detach().clone() for t in p]
    best = [t.detach() for t in best_p]
    return flow_from_leaves(best, n_layers), torch.stack(losses)
