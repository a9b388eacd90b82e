"""Trainable diagonal-Gaussian prior p_θ(z) = N(μ, diag σ²)
(``model.prior='gaussian'``; counterpart of
``apv_tpu/models/gaussian_prior.py``).

(μ, log σ) start at zero, so the model starts as the standard-prior model.
They train through the ELBO's analytic KL, whose gradient moment-matches
the base to the aggregate posterior. It composes with the adversarial D:
the shaped prior becomes p*(z) ∝ N(μ, σ)·e^{D(z)}, whose log Z is drawn
from the current base at evaluation.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from apv_tpu_torch.core.distributions import gaussian_logpdf


class GaussianPrior(nn.Module):
    def __init__(self, z_dim: int):
        super().__init__()
        self.mu = nn.Parameter(torch.zeros(z_dim))
        self.log_sigma = nn.Parameter(torch.zeros(z_dim))

    def forward(self, z: torch.Tensor, *,
                detach_params: bool = False) -> torch.Tensor:
        """log p_θ(z), shape ``z.shape[:-1]``, exact; ``detach_params``
        keeps the gradient from reaching (μ, log σ)."""
        mu, log_sigma = self.mu, self.log_sigma
        if detach_params:
            mu, log_sigma = mu.detach(), log_sigma.detach()
        return torch.sum(gaussian_logpdf(z, mu, 2.0 * log_sigma), dim=-1)

    def sample_from(self, u: torch.Tensor) -> torch.Tensor:
        """Base draws u ~ N(0, I) -> prior draws z = μ + σ·u."""
        return self.mu + torch.exp(self.log_sigma) * u

    def moments(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(μ, σ²), the analytic KL's view."""
        return self.mu, torch.exp(2.0 * self.log_sigma)
