"""Latent-space scatter: the aggregate posterior against the priors
(counterpart of ``apv_tpu/sampling/latent_viz.py``).

The adversarial prior's job is to make p*(z) ∝ N(0, I)·e^{D(z)} cover the
aggregate posterior q(z) = E_x[q(z|x)]. This module draws that claim:
posterior means of encoded test images, draws from N(0, I), from the
ex-post Gaussian fitted to q(z), and from the model's own prior (the
shaped prior by SIR, optionally MALA-refined, under a latent D; the
trained flow's or Gaussian base's draws otherwise), all projected onto the
top-2 principal components of the posterior means.

The encoder and the draws run on the model's device; the PCA is a float64
numpy SVD on the host. The picture is rasterized here (one colour per
cloud) and written by ``utils/png.py``: no plotting library.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from apv_tpu_torch.sampling.run import _normal, sample_prior, seed_generators
from apv_tpu_torch.utils import png


def latent_scatter_data(model, x_in: torch.Tensor, z_dim: int, *,
                        d: Callable | None = None, refine_steps: int = 0,
                        model_prior: str = "standard", seed: int = 0,
                        draws: dict | None = None) -> dict:
    """Posterior means and prior draws, projected to the posterior means'
    top-2 PCs.

    Returns [N, 2] float64 arrays ``posterior``, ``prior`` (N(0, I)) and
    ``expost_prior``, plus ``shaped_prior`` with a latent D ``d`` (SIR over
    the trained Gaussian base where ``model_prior`` is 'gaussian'), else
    ``flow_prior`` or ``gaussian_prior`` for a model with a trained prior
    (``model_prior``, the config's ``model.prior``);
    and ``explained``, the share of the posterior means' variance the two
    PCs carry.

    Draws come from generators derived from ``seed`` and may be injected
    (``draws``): ``prior`` and ``expost`` (N(0, I) [N, Z]) and
    ``sample_prior``'s ``pool``, ``pick``, ``mala_noise`` and
    ``mala_uniforms``.
    """
    draws = draws or {}
    n = int(x_in.shape[0])
    dev = x_in.device
    gen_p, gen_s, gen_e = seed_generators(seed, 3, dev)
    with torch.no_grad():
        mean, logvar = (t.to(torch.float32) for t in model.encode(x_in))
        z_prior = _normal((n, z_dim), gen_p, dev, draws.get("prior"),
                          "prior")
        # the ex-post Gaussian (law of total variance), the fit that
        # sample --prior expost decodes from
        agg_mean = mean.mean(dim=0)
        agg_var = (mean.var(dim=0, unbiased=False)
                   + torch.exp(logvar).mean(dim=0))
        z_expost = agg_mean + torch.sqrt(agg_var) * _normal(
            (n, z_dim), gen_e, dev, draws.get("expost"), "expost")
    base_from = base_logp = None
    model_cloud = None
    if model_prior == "flow":
        with torch.no_grad():
            model_cloud = model.prior_sample_from(z_prior)
    elif model_prior == "gaussian":
        base_from, base_logp = model.prior_sample_from, model.prior_logpdf
        if d is None:
            with torch.no_grad():
                model_cloud = base_from(z_prior)
    if d is not None:
        model_cloud = sample_prior(
            n, z_dim, d=d, refine_steps=refine_steps, generator=gen_s,
            device=dev, base_from=base_from, base_logp=base_logp,
            pool=draws.get("pool"), pick=draws.get("pick"),
            mala_noise=draws.get("mala_noise"),
            mala_uniforms=draws.get("mala_uniforms"))

    mu = mean.cpu().numpy().astype(np.float64)
    centre = mu.mean(axis=0)
    _, s, vt = np.linalg.svd(mu - centre, full_matrices=False)
    basis = vt[:2].T                                        # [Z, 2]
    total = float(np.sum(s ** 2))

    def proj(z: torch.Tensor) -> np.ndarray:
        return (z.detach().to(torch.float32).cpu().numpy().astype(np.float64)
                - centre) @ basis

    out = {"posterior": proj(mean), "prior": proj(z_prior),
           "expost_prior": proj(z_expost),
           "explained": (float(np.sum(s[:2] ** 2) / total) if total > 0
                         else 0.0)}
    if d is not None:
        out["shaped_prior"] = proj(model_cloud)
    elif model_prior in ("flow", "gaussian"):
        out[f"{model_prior}_prior"] = proj(model_cloud)
    return out


# (cloud, RGB, alpha), drawn in this order
STYLES = (
    ("posterior", (0x1F, 0x77, 0xB4), 0.45),
    ("prior", (0x9A, 0xA0, 0xA6), 0.30),
    ("shaped_prior", (0xD6, 0x27, 0x28), 0.45),
    ("flow_prior", (0xD6, 0x27, 0x28), 0.45),
    ("gaussian_prior", (0xD6, 0x27, 0x28), 0.45),
    ("expost_prior", (0x2C, 0xA0, 0x2C), 0.35),
)


def scatter_image(data: dict, size: int = 512, dot: int = 3) -> np.ndarray:
    """The projected clouds of ``latent_scatter_data`` rasterized into a
    [size, size, 3] uint8 image: white ground, PC 1 across and PC 2 up on
    one scale (the clouds' joint extent plus a 5% margin), grey lines
    through the posterior's centre, each cloud's points ``dot`` pixels
    square, alpha-blended in its colour (``STYLES``: posterior blue, N(0, I)
    grey, the model's prior red, the ex-post Gaussian green)."""
    clouds = [(np.asarray(data[k], np.float64), c, a)
              for k, c, a in STYLES if k in data]
    pts = np.concatenate([p for p, _, _ in clouds] + [np.zeros((1, 2))])
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    centre = (lo + hi) / 2.0
    half = max(float((hi - lo).max()) / 2.0, 1e-12) * 1.05
    img = np.full((size, size, 3), 255.0)

    def to_px(p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        u = (p - centre) / half                             # [-1, 1]
        col = np.clip(((u[:, 0] + 1.0) / 2.0 * (size - dot)).round(),
                      0, size - dot).astype(np.int64)
        row = np.clip(((1.0 - u[:, 1]) / 2.0 * (size - dot)).round(),
                      0, size - dot).astype(np.int64)
        return row, col

    r0, c0 = to_px(np.zeros((1, 2)))
    img[:, c0[0] + dot // 2] = 200.0
    img[r0[0] + dot // 2, :] = 200.0
    for p, colour, alpha in clouds:
        row, col = to_px(p)
        for dr in range(dot):
            for dc in range(dot):
                rr, cc = row + dr, col + dc
                img[rr, cc] = ((1.0 - alpha) * img[rr, cc]
                               + alpha * np.asarray(colour, np.float64))
    return img.round().astype(np.uint8)


def save_latent_scatter(data: dict, path: str | Path,
                        size: int = 512) -> Path:
    """``scatter_image`` of the projected clouds, written as one PNG."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(png.encode_png(scatter_image(data, size)))
    return path
