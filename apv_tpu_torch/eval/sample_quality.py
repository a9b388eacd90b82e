"""Sample-quality metrics for the sampling suite (counterpart of
``apv_tpu/eval/sample_quality.py``).

Distances between generated and real test images in a fixed random-conv
feature space: the Fréchet distance (``frechet_rfd``), unbiased RBF MMD²
at the median-heuristic bandwidth, and density/coverage (Naeem et al.
2020). They rank models and detect collapse; they are not comparable to
published FID/PRDC numbers.

The feature net's kernels are the reference's ``feature_params`` for
``feature_seed=0``, drawn by ``jax.random``, which torch cannot redraw:
they ship as ``feature_params.npz`` beside this module (c_in 1 and 3,
generated from ``apv_tpu.eval.sample_quality.feature_params(
jax.random.PRNGKey(0), c)``; a test regenerates and compares them). So the
port's numbers are in the same feature space as ``apv_tpu``'s. Other
seeds raise.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

_PARAMS_FILE = Path(__file__).resolve().parent / "feature_params.npz"


def feature_params(c_in: int, feature_seed: int = 0, *,
                   device=None) -> list[torch.Tensor]:
    """The fixed feature net's three HWIO 3×3 kernels (widths 32, 64, 128)
    for ``c_in`` input channels, as float32 tensors on ``device``."""
    if feature_seed != 0:
        raise ValueError(f"feature_seed={feature_seed}: the port ships the "
                         "reference's kernels for feature_seed=0 only "
                         "(feature_params.npz); torch cannot redraw "
                         "jax.random's")
    with np.load(_PARAMS_FILE) as f:
        names = sorted(k for k in f.files if k.startswith(f"c{c_in}_"))
        if not names:
            raise ValueError(f"no shipped feature kernels for c_in={c_in} "
                             "(have 1 and 3)")
        return [torch.from_numpy(f[k]).to(device) for k in names]


def _same_pad(n: int, k: int = 3, s: int = 2) -> tuple[int, int]:
    """XLA's SAME padding (low, high) for one spatial axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def extract_features(params: list[torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] images in [0, 1] -> [N, 2·widths[-1]] pooled features:
    stride-2 SAME convs with leaky_relu(0.2), then the spatial mean and
    population std concatenated. float32 throughout, TF32 off."""
    h = x.to(torch.float32).permute(0, 3, 1, 2) * 2.0 - 1.0
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for kern in params:
            ph, pw = _same_pad(h.shape[2]), _same_pad(h.shape[3])
            h = F.pad(h, (pw[0], pw[1], ph[0], ph[1]))
            h = F.conv2d(h, kern.permute(3, 2, 0, 1), stride=2)
            h = F.leaky_relu(h, 0.2)
    mean = h.mean(dim=(2, 3))
    std = h.std(dim=(2, 3), unbiased=False)
    return torch.cat([mean, std], dim=-1)


def frechet_distance(f_a: np.ndarray, f_b: np.ndarray) -> float:
    """Fréchet (2-Wasserstein²) distance between Gaussians fit to two
    feature sets: |μa−μb|² + tr(Ca + Cb − 2·(Ca·Cb)^½)."""
    from scipy import linalg

    f_a = np.asarray(f_a, np.float64)
    f_b = np.asarray(f_b, np.float64)
    mu_a, mu_b = f_a.mean(0), f_b.mean(0)
    cov_a = np.cov(f_a, rowvar=False)
    cov_b = np.cov(f_b, rowvar=False)
    eps = 1e-6 * np.eye(cov_a.shape[0])
    covmean = linalg.sqrtm((cov_a + eps) @ (cov_b + eps))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    d2 = (np.sum((mu_a - mu_b) ** 2) + np.trace(cov_a) + np.trace(cov_b)
          - 2.0 * np.trace(covmean))
    return float(max(d2, 0.0))


def _sq_dists(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    xx = (x * x).sum(1)[:, None]
    yy = (y * y).sum(1)[None, :]
    return np.maximum(xx + yy - 2.0 * (x @ y.T), 0.0)


def mmd2_rbf(f_a: np.ndarray, f_b: np.ndarray,
             bandwidth: float | None = None) -> float:
    """Unbiased MMD² with an RBF kernel (median-heuristic bandwidth over
    the pooled pairwise distances when not given)."""
    f_a = np.asarray(f_a, np.float64)
    f_b = np.asarray(f_b, np.float64)
    d_aa, d_bb, d_ab = _sq_dists(f_a, f_a), _sq_dists(f_b, f_b), \
        _sq_dists(f_a, f_b)
    if bandwidth is None:
        pooled = np.concatenate([
            d_aa[np.triu_indices_from(d_aa, 1)],
            d_bb[np.triu_indices_from(d_bb, 1)],
            d_ab.ravel()])
        med = float(np.median(pooled))
        bandwidth = np.sqrt(med / 2.0) if med > 0 else 1.0

    def k(d):
        return np.exp(-d / (2.0 * bandwidth ** 2))

    n, m = len(f_a), len(f_b)
    k_aa = (k(d_aa).sum() - n) / (n * (n - 1))      # drop diagonal (== 1)
    k_bb = (k(d_bb).sum() - m) / (m * (m - 1))
    k_ab = k(d_ab).mean()
    return float(k_aa + k_bb - 2.0 * k_ab)


def density_coverage(f_real: np.ndarray, f_fake: np.ndarray,
                     k: int = 5) -> tuple[float, float]:
    """Density and coverage (Naeem et al. 2020, eqs. 3-4) from the real
    samples' k-NN balls: density = (1/(kM)) Σ_j #{i : g_j ∈ B_i},
    coverage = (1/N) #{i : ∃ j, g_j ∈ B_i}."""
    f_real = np.asarray(f_real, np.float64)
    f_fake = np.asarray(f_fake, np.float64)
    if len(f_real) <= k:
        raise ValueError(f"density_coverage needs > k={k} real samples, "
                         f"got {len(f_real)}")
    rad2 = np.sort(_sq_dists(f_real, f_real), axis=1)[:, k]
    inside = _sq_dists(f_real, f_fake) <= rad2[:, None]
    density = float(inside.sum() / (k * f_fake.shape[0]))
    coverage = float(inside.any(axis=1).mean())
    return density, coverage


def sample_quality(cfg, model, d=None, *, n: int = 2048, seed: int = 0,
                   feature_seed: int = 0, batch_size: int = 256,
                   mode: str = "sample", refine_steps: int = 0,
                   prior_moments=None, model_prior: bool | None = None,
                   model_base: bool | None = None, temperature: float = 1.0,
                   device=None) -> dict:
    """Generated-vs-real distances for a model on ``device`` (``None``: the
    model's). Real side: the test split with train-matched preprocessing
    (``eval/run.eval_arrays``). Generated side: ``generate_samples`` with
    pixel ``mode`` from the shaped prior (``d``; N(0, I) without it), the
    ex-post ``prior_moments``, or the model's trained prior
    (``model_prior``, default: a flow checkpoint without ex-post moments;
    ``model_base``, default: a Gaussian-base checkpoint without them) at
    ``temperature``, batch i seeded from (``seed``, i)."""
    from apv_tpu_torch.eval.run import eval_arrays
    from apv_tpu_torch.sampling.run import generate_samples

    if n < 2:
        raise ValueError(f"sample_quality needs n >= 2, got n={n}")
    d_use = d if cfg.adversarial.enabled else None
    if model_prior is None:
        model_prior = cfg.model.prior == "flow" and prior_moments is None
    if model_base is None:
        model_base = cfg.model.prior == "gaussian" and prior_moments is None
    dev = (torch.device(device) if device is not None
           else next(model.parameters()).device)

    real = eval_arrays(cfg, None, max_examples=n)["image"]
    if real.dtype == np.uint8 and not cfg.data.binarize:
        real = real.astype(np.float32) / 255.0
    real = np.asarray(real, np.float32)
    n = min(n, len(real))
    if n < 2:
        raise ValueError(f"sample_quality needs >= 2 real examples; the "
                         f"test split has {len(real)}")
    real = real[:n]

    h, w, c = cfg.model.image_shape
    fparams = feature_params(c, feature_seed, device=dev)
    f_real, f_fake = [], []
    for i in range(0, n, batch_size):
        b = min(batch_size, n - i)
        batch_seed = int(np.random.SeedSequence([seed, i]).generate_state(1)[0])
        fake = generate_samples(model, b, cfg.model.z_dim,
                                cfg.model.likelihood, c, d=d_use,
                                seed=batch_seed, mode=mode,
                                refine_steps=refine_steps,
                                prior_moments=prior_moments,
                                model_prior=model_prior,
                                model_base=model_base,
                                temperature=temperature)
        with torch.no_grad():
            f_fake.append(extract_features(fparams, fake).cpu().numpy())
            f_real.append(extract_features(
                fparams, torch.from_numpy(real[i:i + b]).to(dev)
            ).cpu().numpy())
    f_real = np.concatenate(f_real)
    f_fake = np.concatenate(f_fake)
    density, coverage = density_coverage(f_real, f_fake)
    return {
        "frechet_rfd": frechet_distance(f_real, f_fake),
        "mmd2_rbf": mmd2_rbf(f_real, f_fake),
        "density": density,
        "coverage": coverage,
        "n": int(n),
        "pixel_mode": mode,
        "feature_seed": int(feature_seed),
        "refine_steps": int(refine_steps),
    }
