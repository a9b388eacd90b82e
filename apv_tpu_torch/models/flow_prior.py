"""Trained RealNVP prior p_θ(z) (``model.prior='flow'``; counterpart of
``apv_tpu/models/flow_prior.py``).

Trained jointly with the VAE by the ELBO, whose −β·E_q[log q − log p_θ]
term is, for the flow's parameters, maximum likelihood on posterior
samples. Exact density, exact log Z = 0 at evaluation, exact inverse for
sampling. Excludes the adversarial D (``training/step.py`` refuses both).

The parameters are ``core/flow.init_flow``'s tree in its own layout
(``w1`` [Z, H], ...), each a plain ``nn.Parameter``, the whitening
``mean`` and ``log_std`` included: in the reference the whole flow is one
trained param, so the optimizer updates the whitening too. No ``Dense``:
the registry's lecun-normal init would overwrite the zero last layers,
which make the flow start as the identity.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from apv_tpu_torch.core.flow import flow_inverse, flow_logpdf, init_flow


class FlowPrior(nn.Module):
    def __init__(self, z_dim: int, n_layers: int = 6, hidden: int = 64):
        super().__init__()
        flow = init_flow(z_dim, n_layers=n_layers, hidden=hidden,
                         draws=[(np.zeros((z_dim, hidden)),
                                 np.zeros((hidden, hidden)))] * n_layers)
        self.z_dim, self.hidden = z_dim, hidden
        self.whiten = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in flow["whiten"].items()})
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(v) for k, v in layer.items()})
            for layer in flow["layers"])

    @torch.no_grad()
    def reset_parameters(self, rng: np.random.Generator) -> None:
        """He-normal hidden layers from ``rng``, zero biases and last
        layers, no whitening: the identity map."""
        for layer in self.layers:
            for name, fan_in in (("w1", self.z_dim), ("w2", self.hidden)):
                w = layer[name]
                w.copy_(torch.from_numpy(rng.standard_normal(tuple(w.shape)))
                        * math.sqrt(2.0 / fan_in))
            for name in ("b1", "b2", "w3", "b3"):
                layer[name].zero_()
        for p in self.whiten.values():
            p.zero_()

    def flow(self, *, detach_params: bool = False) -> dict:
        """The parameters as ``core/flow``'s dict."""
        f = (lambda p: p.detach()) if detach_params else (lambda p: p)
        return {"whiten": {k: f(v) for k, v in self.whiten.items()},
                "layers": [{k: f(v) for k, v in layer.items()}
                           for layer in self.layers]}

    def forward(self, z: torch.Tensor, *,
                detach_params: bool = False) -> torch.Tensor:
        """log p_θ(z), shape ``z.shape[:-1]``, exact."""
        return flow_logpdf(self.flow(detach_params=detach_params), z)

    def sample_from(self, u: torch.Tensor) -> torch.Tensor:
        """Base draws u ~ N(0, I) -> prior draws z (the exact inverse)."""
        return flow_inverse(self.flow(), u)
