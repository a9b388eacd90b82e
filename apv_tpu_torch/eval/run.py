"""``evaluate_nll``: test-set NLL via IWAE-k and bits/dim on one device,
and ``eval_arrays``, the test split as eval sees it (counterpart of
``apv_tpu/eval/run.py:26-53,218-399``).

Deterministic input convention at eval: no dequantization noise — the
encoder sees centered bin centers, the likelihood scores the discrete
levels.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from apv_tpu_torch.core.metrics import nats_to_bits_per_dim
from apv_tpu_torch.data.datasets import load_dataset
from apv_tpu_torch.data.preprocess import (normalize_center, static_binarize,
                                           to_unit_interval)
from apv_tpu_torch.eval.iwae_eval import estimate_log_partition, make_iwae_fn
from apv_tpu_torch.utils.config import Config
from apv_tpu_torch.utils.device import resolve_device


def eval_arrays(cfg: Config, dataset: str | None = None,
                max_examples: int | None = None) -> dict[str, np.ndarray]:
    """The test split of ``dataset`` (default ``cfg.data.dataset``) with
    train-matched preprocessing: the binarized configs binarize it once
    with the seed ``cfg.train.seed + 1``; uint8 levels otherwise. Cut to
    the first ``max_examples``."""
    images, _ = load_dataset(dataset or cfg.data.dataset, "test",
                             data_dir=cfg.data.data_dir,
                             synthetic_size=cfg.data.synthetic_size)
    if cfg.data.binarize:
        images = static_binarize(images, seed=cfg.train.seed + 1)
    if max_examples is not None:
        images = images[:max_examples]
    return {"image": images}


def _prep_eval_batch(cfg: Config, image: np.ndarray):
    """Host-side (numpy) eval preprocessing -> (x_in, x_target).

    Binarized configs feed x straight through; continuous configs center
    the encoder input to [-1,1] while the likelihood scores the raw [0,1]
    bin centers."""
    if cfg.data.binarize:
        x = np.asarray(image, np.float32)
        return x, x
    levels = (to_unit_interval(image) if image.dtype == np.uint8
              else np.asarray(image, np.float32))
    return normalize_center(levels), levels


def _divisor_chunk(k: int, chunk: int) -> int:
    if k % chunk == 0:
        return chunk
    eff = max(d for d in range(1, min(chunk, k) + 1) if k % d == 0)
    warnings.warn(f"iwae chunk {chunk} does not divide k={k}; using "
                  f"chunk={eff} (largest divisor). Pick a divisor of k to "
                  "silence this.", stacklevel=3)
    return eff


def evaluate_nll(cfg: Config, model, d, images_u8: np.ndarray, *,
                 k: int | None = None, chunk: int | None = None,
                 batch_size: int | None = None, seed: int = 0,
                 use_adversarial_prior: bool | None = None,
                 per_sample: bool = False, device=None) -> dict:
    """Mean NLL (nats) and bits/dim of ``images_u8`` [N, H, W, C] under the
    IWAE-k estimator, batch by batch (the last partial batch is dropped, as
    the reference's eval Batcher does), under the checkpoint's own prior.

    A trained prior (``model.prior``) is scored exactly: the flow (with
    log Z = 0: it excludes the adversarial D) and the Gaussian base, which
    composes with D. With the adversarial prior (``use_adversarial_prior``,
    default ``cfg.adversarial.enabled``; it needs the latent D ``d``), log Z
    is MC-estimated first (n=100k draws from the base the weights use, the
    current N(μ, σ) for the Gaussian base; jackknife SE). Batch ``i`` draws
    its noise from a CPU generator seeded ``seed + i``.
    """
    dev = resolve_device(device)
    model = model.to(dev)
    k = k if k is not None else cfg.eval.iwae_k
    chunk = _divisor_chunk(k, chunk if chunk is not None
                           else min(cfg.eval.iwae_chunk, k))
    use_adv = (cfg.adversarial.enabled if use_adversarial_prior is None
               else use_adversarial_prior)
    if use_adv and d is None:
        raise ValueError("the adversarial prior needs the latent D")
    batch_size = min(batch_size if batch_size is not None
                     else cfg.eval.batch_size, len(images_u8))
    n_batches = len(images_u8) // batch_size
    if n_batches == 0:
        raise ValueError("evaluate_nll: no images to score")

    d_apply = None
    model_prior = cfg.model.prior
    prior_logpdf_p = None
    if (model_prior == "flow" and not use_adv) or model_prior == "gaussian":
        prior_logpdf_p = model.prior_logpdf
    log_z = torch.zeros((), device=dev)
    log_z_se = torch.zeros((), device=dev)
    with torch.inference_mode():
        if use_adv:
            d_apply = d.to(dev)
            base_from = (model.prior_sample_from
                         if model_prior == "gaussian" else None)
            log_z, log_z_se = estimate_log_partition(
                d_apply, cfg.model.z_dim, seed=seed + 17, with_se=True,
                device=dev, base_from=base_from)
        iwae_fn = make_iwae_fn(model, cfg.model.likelihood, k, chunk,
                               d_apply, prior_logpdf_p=prior_logpdf_p)
        scores = []
        for i in range(n_batches):
            x_in, x_target = _prep_eval_batch(
                cfg, images_u8[i * batch_size:(i + 1) * batch_size])
            gen = torch.Generator().manual_seed(seed + i)
            ll = iwae_fn(torch.from_numpy(x_in).to(dev),
                         torch.from_numpy(x_target).to(dev), log_z,
                         generator=gen)
            scores.append(ll.cpu())
    scores = torch.cat(scores).double().numpy()

    h, w, c = cfg.model.image_shape
    nll = float(-scores.mean())
    result = {
        "nll_nats": nll,
        # SEM over test examples; the log-Z MC error bar is
        # log_partition_se below
        "nll_nats_se": float(scores.std(ddof=1)
                             / np.sqrt(max(scores.shape[0], 2))),
        "bits_per_dim": float(nats_to_bits_per_dim(nll, h * w * c)),
        "iwae_k": k,
        "num_examples": int(scores.shape[0]),
        "log_partition": float(log_z),
        "log_partition_se": float(log_z_se),
        "adversarial_prior": bool(use_adv),
        "prior": "model",
    }
    if per_sample:
        result["per_sample"] = scores
    return result
