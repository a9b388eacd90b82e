"""``evaluate_nll``: test-set NLL via IWAE-k and bits/dim on one device,
under the model's own prior or an ex-post prior; ``posterior_activity``,
the active-units diagnostic; ``pixel_d_scores``, the biadversarial pixel
D's logits; and ``eval_arrays``, the test split as eval sees it
(counterpart of ``apv_tpu/eval/run.py``).

Deterministic input convention at eval: no dequantization noise — the
encoder sees centered bin centers, the likelihood scores the discrete
levels.

Under a process group the ranks share the work and every rank returns the
whole result. ``evaluate_nll`` lays the ranks out as an n_data × n_k grid,
n_k = min(``eval.k_shards``, world), which must divide the world size:
each data row of ranks scores its rows of every batch and its n_k ranks
split the k samples (``eval/sharded.py``); the per-sample scores are
gathered in global row order onto every rank, and log Z is estimated on
every rank from the same seed. The batch is rounded to split over the
data shards (``_eval_batch_size``). With more than one data shard the
noise differs from a one-process run's (the data index is folded into the
batch seeds); a group of one scores as no group does, bit for bit.
``posterior_activity`` and ``pixel_d_scores`` split each batch over the
ranks and gather their outputs. This rule is the port's own: the
reference's multi-host guard, which asks that a row of its device mesh lie
within one process, has no counterpart with one process a card.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from apv_tpu_torch.core.metrics import active_units, nats_to_bits_per_dim
from apv_tpu_torch.data.datasets import load_dataset
from apv_tpu_torch.data.pipeline import Batcher
from apv_tpu_torch.data.preprocess import (normalize_center, static_binarize,
                                           to_unit_interval)
from apv_tpu_torch.eval.iwae_eval import estimate_log_partition
from apv_tpu_torch.parallel import multihost
from apv_tpu_torch.parallel.mesh import make_grid_2d
from apv_tpu_torch.utils.config import Config, refuse_hierarchical
from apv_tpu_torch.utils.device import resolve_device
from apv_tpu_torch.utils.logging import (invocation, read, span, upload,
                                         waits)


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
                  "silence this.", stacklevel=4)
    return eff


def _eval_batch_size(requested: int, n_rows: int, n_shards: int) -> int:
    """The eval batch: capped by the split, rounded down to split over
    ``n_shards`` data shards (``multihost.round_global_batch``); a split
    too small for one such batch is refused, not scored as nothing."""
    if n_rows == 0:
        raise ValueError("no images to score")
    bs = multihost.round_global_batch(min(requested, n_rows), pcount=1,
                                      n_shards=n_shards)
    if bs > n_rows:
        raise ValueError(
            f"eval split has only {n_rows} rows but the smallest batch "
            f"that splits over {n_shards} data shards is {bs}; raise "
            "max_examples or evaluate on fewer ranks")
    return bs


def _batches(cfg: Config, images: np.ndarray, batch_size: int,
             shard: tuple[int, int], dev):
    """(x_in, x_target) batches of ``batch_size`` rows in order, the last
    partial batch dropped, as the reference's eval Batcher does; with
    ``shard=(d, n)`` the d-th of n contiguous parts of each. Each goes to
    ``dev`` as the caller reaches it."""
    batcher = Batcher({"image": images}, batch_size, shuffle=False,
                      host_shard=shard)
    for b in batcher.epoch():
        x_in, x_target = _prep_eval_batch(cfg, b["image"])
        with waits("upload", 2):      # from pageable host memory
            pair = (torch.from_numpy(x_in).to(dev),
                    torch.from_numpy(x_target).to(dev))
        yield pair


def _rank_batches(cfg: Config, images: np.ndarray, batch_size: int, dev):
    """This rank's parts of the batches: one data shard a rank (all of
    each batch without a group)."""
    world = multihost.process_count()
    bs = _eval_batch_size(batch_size, len(images), world)
    return _batches(cfg, images, bs, (multihost.process_index(), world), dev)


def posterior_activity(cfg: Config, model, images_u8: np.ndarray, *,
                       threshold: float = 1e-2,
                       batch_size: int | None = None, device=None) -> dict:
    """Active latent units over ``images_u8`` (IWAE paper §5.1: unit u is
    active if Cov_x(E_q[z_u]) > ``threshold``), a posterior-collapse
    report beside the NLL: one encoder pass, batch by batch
    (``cfg.eval.batch_size``, the last partial batch dropped)."""
    dev = resolve_device(device)
    model = model.to(dev)
    batches = _rank_batches(cfg, images_u8, batch_size if batch_size
                            is not None else cfg.eval.batch_size, dev)

    def means():
        with torch.inference_mode():
            for x_in, _ in batches:
                m = model.encode(x_in)[0].float()
                if multihost.process_count() > 1:
                    m = multihost.all_gather_rows(m)
                yield m.cpu().numpy()

    count, var = active_units(means(), threshold=threshold)
    return {"active_units": count, "z_dim": int(cfg.model.z_dim),
            "threshold": threshold,
            "max_unit_variance": float(var.max()),
            "median_unit_variance": float(np.median(var))}


def pixel_d_scores(cfg: Config, pixel_d, images_u8: np.ndarray, *,
                   batch_size: int | None = None,
                   device=None) -> np.ndarray:
    """Per-image logits D_x(x) [N] of the biadversarial pixel D, the
    ``ood.score='pixel_d'`` score: one D_x forward per image, on the
    target-space batch the training D saw as real (binary pixels or [0, 1]
    levels), batch by batch (``cfg.ood.batch_size``, the last partial
    batch dropped)."""
    dev = resolve_device(device)
    pixel_d = pixel_d.to(dev)
    batches = _rank_batches(cfg, images_u8, batch_size if batch_size
                            is not None else cfg.ood.batch_size, dev)
    scores = []
    with torch.inference_mode():
        for _, x_target in batches:
            s = pixel_d(x_target).float()
            if multihost.process_count() > 1:
                s = multihost.all_gather_rows(s)
            scores.append(s.cpu())
    return torch.cat(scores).double().numpy()


def evaluate_nll(cfg: Config, model, d, images_u8: np.ndarray, *,
                 k: int | None = None, chunk: int | None = None,
                 batch_size: int | None = None, seed: int = 0,
                 use_adversarial_prior: bool | None = None,
                 per_sample: bool = False, prior_moments=None,
                 device=None) -> dict:
    """Mean NLL (nats) and bits/dim of ``images_u8`` [N, H, W, C] under the
    IWAE-k estimator, batch by batch (the last partial batch is dropped, as
    the reference's eval Batcher does), under the checkpoint's own prior or,
    given ``prior_moments``, an ex-post prior.

    A trained prior (``model.prior``) is scored exactly: the flow (with
    log Z = 0: it excludes the adversarial D) and the Gaussian base, which
    composes with D. With the adversarial prior (``use_adversarial_prior``,
    default ``cfg.adversarial.enabled``; it needs the latent D ``d``), log Z
    is MC-estimated first (n=100k draws from the base the weights use, the
    current N(μ, σ) for the Gaussian base; jackknife SE). Batch ``i`` draws
    its noise from a CPU generator seeded ``seed + i``. Under a process
    group the ranks form the (data, k) grid of the module docstring.

    ``prior_moments`` (a fitted ex-post prior on ``device``: ``(mean,
    var)``, ``(log_w, means, vars)`` or a flow dict, as ``sampling.run``
    fits them) scores
    under that exact prior instead: the adversarial correction is off and
    log Z stays 0; ``use_adversarial_prior=True`` beside it raises. The
    result's ``"prior"`` says which: ``model``, ``expost``, ``expost_gmm``
    or ``expost_flow``.

    The call is one ``evaluate_nll`` invocation of the span recorder
    (``utils/logging.py``), whose summary adds ``images``, the rows scored
    here: spans ``eval.log_partition``, ``eval.batch`` (one ``iwae_fn``
    call, a unit), ``eval.chunk`` (one chunk's log weights) and
    ``eval.readback`` (the scores and log Z read back), with device
    markers at the start of each batch and chunk and around log Z.
    """
    refuse_hierarchical(cfg.model, "evaluate_nll")
    if prior_moments is not None and use_adversarial_prior:
        raise ValueError("prior_moments (ex-post prior) and "
                         "use_adversarial_prior are mutually exclusive: "
                         "each is a complete reading of log p(z)")
    dev = resolve_device(device)
    with invocation("evaluate_nll", dev) as summary:
        result = _evaluate_nll(cfg, model, d, images_u8, k, chunk,
                               batch_size, seed, use_adversarial_prior,
                               per_sample, prior_moments, dev)
        summary["images"] = result["num_examples"]
    return result


def _evaluate_nll(cfg, model, d, images_u8, k, chunk, batch_size, seed,
                  use_adversarial_prior, per_sample, prior_moments,
                  dev) -> dict:
    model = upload(model, device=dev)
    k = k if k is not None else cfg.eval.iwae_k
    chunk = _divisor_chunk(k, chunk if chunk is not None
                           else min(cfg.eval.iwae_chunk, k))
    use_adv = (cfg.adversarial.enabled if use_adversarial_prior is None
               else use_adversarial_prior)
    prior_logpdf = None
    if prior_moments is not None:
        use_adv = False
        from apv_tpu_torch.sampling.run import expost_prior_logpdf
        prior_logpdf = expost_prior_logpdf(prior_moments)
    if use_adv and d is None:
        raise ValueError("the adversarial prior needs the latent D")
    batch_size = min(batch_size if batch_size is not None
                     else cfg.eval.batch_size, len(images_u8))

    d_apply = None
    model_prior = cfg.model.prior
    prior_logpdf_p = None
    if prior_logpdf is None and ((model_prior == "flow" and not use_adv)
                                 or model_prior == "gaussian"):
        prior_logpdf_p = model.prior_logpdf
    log_z = torch.zeros((), device=dev)
    log_z_se = torch.zeros((), device=dev)
    with torch.inference_mode():
        if use_adv:
            d_apply = upload(d, device=dev)
            base_from = (model.prior_sample_from
                         if model_prior == "gaussian" else None)
            with span("eval.log_partition", unit=0, marks="both"):
                log_z, log_z_se = estimate_log_partition(
                    d_apply, cfg.model.z_dim, seed=seed + 17, with_se=True,
                    device=dev, base_from=base_from)
        scores = _grid_scores(cfg, model, images_u8, k, chunk, d_apply,
                              prior_logpdf_p, prior_logpdf, log_z, seed,
                              batch_size, dev)
        with span("eval.readback"):
            with waits("read"):
                scores = scores.cpu()
            log_z, log_z_se = read(log_z), read(log_z_se)
        scores = scores.double().numpy()

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
        "log_partition": log_z,
        "log_partition_se": log_z_se,
        "adversarial_prior": bool(use_adv),
        "prior": ("model" if prior_moments is None
                  else "expost_flow" if isinstance(prior_moments, dict)
                  else "expost" if len(prior_moments) == 2
                  else "expost_gmm"),
    }
    if per_sample:
        result["per_sample"] = scores
    return result


def _grid_scores(cfg: Config, model, images_u8: np.ndarray, k: int,
                 chunk: int, d_apply, prior_logpdf_p, prior_logpdf, log_z,
                 seed: int, batch_size: int, dev) -> torch.Tensor:
    """``evaluate_nll``'s per-sample scores, in global row order on every
    rank (module docstring), on the device; without a group the grid is
    1 × 1."""
    from apv_tpu_torch.eval.sharded import make_sharded_iwae_fn
    world = multihost.process_count()
    n_k = min(cfg.eval.k_shards, world)
    if world % n_k:
        raise ValueError(f"eval.k_shards={cfg.eval.k_shards}: the k-axis "
                         f"size {n_k} does not divide the {world} ranks")
    grid = make_grid_2d(world // n_k, n_k)
    iwae_fn = make_sharded_iwae_fn(model, cfg.model.likelihood, k, chunk,
                                   grid, d_apply,
                                   prior_logpdf_p=prior_logpdf_p,
                                   prior_logpdf=prior_logpdf)
    bs = _eval_batch_size(batch_size, len(images_u8), grid.n_data)
    batches = _batches(cfg, images_u8, bs, (grid.data_index, grid.n_data),
                       dev)
    per_batch = []
    for i, (x_in, x_target) in enumerate(batches):
        with span("eval.batch", unit=i, marks="start"):
            per_batch.append(iwae_fn(x_in, x_target, log_z, seed=seed + i))
    scores = torch.stack(per_batch)[None]         # [1, n_batches, per]
    if world > 1:
        # [world, n_batches, per]: one row of ranks a data shard, the
        # first rank of each row in data order
        scores = multihost.all_gather_rows(scores)[::n_k]
    return scores.transpose(0, 1).reshape(-1)
