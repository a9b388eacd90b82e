"""OOD scoring suite, config 5 (counterpart of ``apv_tpu/eval/ood.py``).

Per-sample scores on an in-distribution test set against an OOD test set,
and AUROC in both labelings. Scores (``cfg.ood.score``):

* ``iwae``: per-sample IWAE-k log-likelihood under the model's prior;
* ``elbo``: the same at k=1;
* ``prior_ratio``: log p*(x) − log p0(x), the model scored with the
  adversarially shaped prior against the base N(0, I) prior (the preset's
  default);
* ``model_ratio``: log p_A(x) − log p_B(x) under two checkpoints (the
  baseline, ``ood.baseline_of``, scores the same examples);
* ``pixel_d``: the biadversarial pixel D's realness logit D_x(x), one
  conv forward per image (biadversarial checkpoints only,
  ``eval/run.pixel_d_scores``);
* ``complexity``: log p(x) + L(x), with L(x) the PNG codelength in nats
  (Serrà et al. 2020), from the port's own PNG encoder
  (``utils/png.py``, byte for byte what Pillow writes).

``d`` throughout is the checkpoint's whole D: under the biadversarial
variant the ``{"latent", "pixel"}`` pair, whose latent D the likelihood
scores read (``models.latent_d_params``) and whose pixel D ``pixel_d``
reads.

Under a process group the scores come from ``evaluate_nll`` and
``pixel_d_scores``, which share each batch over the ranks and return the
whole score vector on every rank, so every rank computes the same AUROC.

``ood_both`` runs both pair directions, optionally with a second model
trained on the other dataset for the reversed direction.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from apv_tpu_torch.eval.run import eval_arrays, evaluate_nll, pixel_d_scores
from apv_tpu_torch.models.discriminator import latent_d_params
from apv_tpu_torch.utils import png
from apv_tpu_torch.utils.config import Config


def auroc(in_scores: np.ndarray, ood_scores: np.ndarray) -> float:
    """AUROC of 'higher score ⇒ in-distribution': the Mann–Whitney U of
    the in-scores over n_in·n_ood, with average ranks for ties (the same
    number as sklearn's ``roc_auc_score``)."""
    in_scores = np.asarray(in_scores, np.float64).ravel()
    ood_scores = np.asarray(ood_scores, np.float64).ravel()
    n1, n0 = len(in_scores), len(ood_scores)
    if n1 == 0 or n0 == 0:
        raise ValueError("auroc needs in- and out-of-distribution scores")
    from scipy.stats import rankdata    # slow to import: only when used
    ranks = rankdata(np.concatenate([in_scores, ood_scores]))
    u = ranks[:n1].sum() - n1 * (n1 + 1) / 2.0
    return float(u / (n1 * n0))


def fpr_at_tpr(in_scores: np.ndarray, ood_scores: np.ndarray,
               tpr: float = 0.95) -> float:
    """FPR at the threshold admitting ``tpr`` of in-distribution inputs
    (higher score ⇒ in-distribution; the in-score quantile, method
    'lower', so ties count as admitted)."""
    thresh = np.quantile(in_scores, 1.0 - tpr, method="lower")
    return float(np.mean(ood_scores >= thresh))


def _per_sample(cfg: Config, model, d, dataset: str, *, use_adv: bool,
                k: int, seed: int, device) -> np.ndarray:
    images = eval_arrays(cfg, dataset,
                         max_examples=cfg.ood.max_examples)["image"]
    return evaluate_nll(cfg, model, d, images, k=k,
                        chunk=min(cfg.ood.iwae_chunk, k),
                        batch_size=cfg.ood.batch_size, seed=seed,
                        use_adversarial_prior=use_adv, per_sample=True,
                        device=device)["per_sample"]


def complexity_nats(cfg: Config, dataset: str) -> np.ndarray:
    """Per-image codelength L(x) in nats under PNG (deflate + scanline
    filters, Pillow's choices at ``optimize=True``), over exactly the
    pixel levels the model's likelihood scores: the binarized configs'
    {0, 1} as {0, 255} grayscale, the continuous configs' uint8 levels."""
    imgs = eval_arrays(cfg, dataset,
                       max_examples=cfg.ood.max_examples)["image"]
    if cfg.data.binarize:
        px = np.asarray(imgs, np.uint8) * 255
    elif imgs.dtype == np.uint8:
        px = imgs
    else:
        px = np.clip(np.asarray(imgs, np.float32) * 255.0 + 0.5,
                     0, 255).astype(np.uint8)
    nbytes = png.encoded_sizes(px)
    return 8.0 * nbytes.astype(np.float64) * math.log(2.0)


def _align_to(primary: Config, other: Config) -> Config:
    """The other model's architecture and adversarial sections with the
    primary's data, eval, ood and train sections, so both score the same
    examples (train carries the test-binarization seed)."""
    return dataclasses.replace(other, data=primary.data, eval=primary.eval,
                               ood=primary.ood, train=primary.train)


def ood_scores(cfg: Config, model, d=None, *, seed: int = 0, baseline=None,
               device=None) -> dict:
    """The suite for (``cfg.ood.in_dataset``, ``cfg.ood.ood_dataset``).

    ``d`` is the checkpoint's D (None for a plain-prior model; the pair
    under the biadversarial variant). ``baseline`` is ``(cfg_b, model_b,
    d_b)``, required by ``score='model_ratio'``. Returns per-direction
    AUROCs, FPR@95 and summary statistics.
    """
    score = cfg.ood.score
    k = cfg.ood.iwae_k if score != "elbo" else 1
    d_full, d = d, latent_d_params(cfg.adversarial.variant, d)

    def score_dataset(name: str) -> np.ndarray:
        if score == "pixel_d":
            if (not cfg.adversarial.enabled
                    or cfg.adversarial.variant != "biadversarial"
                    or not (isinstance(d_full, torch.nn.ModuleDict)
                            and "pixel" in d_full)):
                raise ValueError(
                    "pixel_d score needs a biadversarial checkpoint "
                    "(adversarial.variant=biadversarial trains the "
                    "pixel-space discriminator it scores with)")
            images = eval_arrays(cfg, name,
                                 max_examples=cfg.ood.max_examples)["image"]
            return pixel_d_scores(cfg, d_full["pixel"], images,
                                  device=device)
        if score == "prior_ratio":
            if d is None or not cfg.adversarial.enabled:
                raise ValueError(
                    "prior_ratio score needs an adversarial checkpoint")
            adv = _per_sample(cfg, model, d, name, use_adv=True, k=k,
                              seed=seed, device=device)
            base = _per_sample(cfg, model, d, name, use_adv=False, k=k,
                               seed=seed, device=device)
            return adv - base
        if score == "model_ratio":
            if baseline is None:
                raise ValueError("model_ratio score needs a baseline model "
                                 "(ood.baseline_of)")
            cfg_b, model_b, d_b = baseline
            cfg_b = _align_to(cfg, cfg_b)
            a = _per_sample(cfg, model, d, name,
                            use_adv=cfg.adversarial.enabled, k=k, seed=seed,
                            device=device)
            b = _per_sample(cfg_b, model_b,
                            latent_d_params(cfg_b.adversarial.variant, d_b),
                            name,
                            use_adv=cfg_b.adversarial.enabled, k=k,
                            seed=seed, device=device)
            return a - b
        if score == "complexity":
            ll = _per_sample(cfg, model, d, name,
                             use_adv=cfg.adversarial.enabled, k=k,
                             seed=seed, device=device)
            # eval_arrays' order is the scoring order; the batch loop drops
            # a remainder, so the codelengths are cut to the scored prefix
            return ll + complexity_nats(cfg, name)[:len(ll)]
        if score not in ("iwae", "elbo"):
            raise ValueError(
                f"unknown ood.score {score!r} (iwae | elbo | prior_ratio "
                "| model_ratio | pixel_d | complexity)")
        return _per_sample(cfg, model, d, name,
                           use_adv=cfg.adversarial.enabled, k=k, seed=seed,
                           device=device)

    in_s = score_dataset(cfg.ood.in_dataset)
    ood_s = score_dataset(cfg.ood.ood_dataset)
    return {
        "score": score,
        "in_dataset": cfg.ood.in_dataset,
        "ood_dataset": cfg.ood.ood_dataset,
        "auroc_in_vs_ood": auroc(in_s, ood_s),
        "auroc_ood_vs_in": auroc(-in_s, -ood_s),
        "fpr_at_95_tpr": fpr_at_tpr(in_s, ood_s),
        "in_mean": float(in_s.mean()), "ood_mean": float(ood_s.mean()),
        "n_in": int(in_s.shape[0]), "n_ood": int(ood_s.shape[0]),
    }


def ood_both(cfg: Config, model, d=None, *, seed: int = 0, baseline=None,
             reverse=None, device=None) -> dict:
    """Both pair directions. Forward: (in_dataset vs ood_dataset) with
    this model. Reverse: the datasets swapped, scored by ``reverse`` =
    ``(cfg_r, model_r, d_r)``, a model trained on ood_dataset, or by this
    model when none is given. With ``score='model_ratio'`` and a reverse
    model, the reverse direction's denominator is this model."""
    fwd = ood_scores(cfg, model, d, seed=seed, baseline=baseline,
                     device=device)
    swapped_ood = dataclasses.replace(
        cfg.ood, in_dataset=cfg.ood.ood_dataset,
        ood_dataset=cfg.ood.in_dataset)
    if reverse is not None:
        cfg_r, model_r, d_r = reverse
        cfg_r = dataclasses.replace(_align_to(cfg, cfg_r), ood=swapped_ood)
        rev_baseline = baseline
        if cfg.ood.score == "model_ratio":
            # the roles swap with the datasets: each direction's numerator
            # is its own-dataset model, its denominator the other one
            rev_baseline = (cfg, model, d)
        rev = ood_scores(cfg_r, model_r, d_r, seed=seed,
                         baseline=rev_baseline, device=device)
    else:
        rev = ood_scores(dataclasses.replace(cfg, ood=swapped_ood), model, d,
                         seed=seed, baseline=baseline, device=device)
    return {"forward": fwd, "reverse": rev,
            "reverse_model": "own" if reverse is not None else "shared"}
