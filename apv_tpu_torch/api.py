"""Public entry points for config 5: ``sample`` and ``ood_score``
(counterpart of ``apv_tpu/api.py:18-111,193-330,561-609``).

Each is config-driven (a preset name or Config, plus dot-path overrides),
restores the port's own checkpoint (``utils/checkpoint.py``) and writes its
result next to the run. Eval-side entry points adopt the checkpoint's saved
``config.json``: its model, adversarial and data sections (preprocessing
must match training), then re-apply the caller's overrides.

A checkpoint with a trained prior (``model.prior='flow'`` or
``'gaussian'``) samples and scores under it: ``sample``'s 'auto' prior is
the flow's exact inverse, or SIR over the Gaussian base with its D, at
``temperature``; ``ood_score`` scores under the checkpoint's own prior
through ``evaluate_nll``.

Not ported: ``train``/``evaluate``/``visualize``/``export_artifact``/
``info`` and the CLI (ROADMAP queue A item 14; ``train_loop`` and
``evaluate_nll`` are the port's training and scoring entry points).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import torch

from apv_tpu_torch.utils.config import (Config, apply_overrides,
                                        config_from_dict, get_preset)
from apv_tpu_torch.utils.device import resolve_device

_PRIORS = ("auto", "standard", "expost", "expost_gmm", "expost_flow")


def _resolve(config: str | Config, overrides: list[str] | None) -> Config:
    cfg = get_preset(config) if isinstance(config, str) else config
    return apply_overrides(cfg, overrides or [])


def _saved_config(cfg: Config, checkpoint_dir: str | None = None,
                  name: str | None = None) -> Config | None:
    """The config.json saved beside the checkpoint this cfg points at, or
    beside the results-dir run ``name``; None if absent."""
    if checkpoint_dir is not None:
        cfg_path = Path(checkpoint_dir).parent / "config.json"
    else:
        owner = name or cfg.checkpoint_of or cfg.name
        cfg_path = Path(cfg.results_dir) / owner / "config.json"
    if not cfg_path.exists():
        return None
    return config_from_dict(json.loads(cfg_path.read_text()))


def _adopt_checkpoint_arch(cfg: Config, overrides: list[str] | None,
                           checkpoint_dir: str | None = None) -> Config:
    """Snap the model, adversarial and data sections (and train.ema_decay
    and train.seed) to the checkpoint's saved config, then re-apply the
    explicit overrides."""
    saved = _saved_config(cfg, checkpoint_dir)
    if saved is None:
        return cfg
    cfg = dataclasses.replace(cfg, model=saved.model,
                              adversarial=saved.adversarial,
                              data=saved.data,
                              train=dataclasses.replace(
                                  cfg.train, ema_decay=saved.train.ema_decay,
                                  seed=saved.train.seed))
    return apply_overrides(cfg, overrides or [])


def _restore_state(cfg: Config, checkpoint_dir: str | None = None, *,
                   device=None):
    """A fresh ``init_fn`` state with the newest checkpoint copied in;
    eval-only presets read the training preset's (``checkpoint_of``)."""
    from apv_tpu_torch.training.step import make_train_fns
    from apv_tpu_torch.utils import checkpoint as ckpt

    state = make_train_fns(cfg, device=device).init_fn(cfg.train.seed)
    owner = cfg.checkpoint_of or cfg.name
    ckpt_dir = (Path(checkpoint_dir) if checkpoint_dir
                else Path(cfg.results_dir) / owner / "checkpoints")
    return ckpt.restore_checkpoint(ckpt_dir, state)


def _write_json(cfg: Config, name: str, data: dict) -> None:
    from apv_tpu_torch.utils.logging import MetricLogger
    MetricLogger(Path(cfg.results_dir) / cfg.name).write_json(name, data)


def _d(state, cfg: Config):
    """The latent D eval-side entry points consume (None when the run is
    not adversarial)."""
    return state.d if cfg.adversarial.enabled else None


def _expost_prior(cfg: Config, model, prior: str, *, gmm_k: int = 10,
                  flow_steps: int = 2000, seed: int = 0, device=None):
    """Fit the requested ex-post prior on the first 2,048 test images,
    preprocessed as training saw them: ``(mean, var)`` for 'expost',
    ``(log_w, means, vars)`` for 'expost_gmm', a flow params dict for
    'expost_flow' (``flow_steps`` fit steps; prints the fit's final NLL and
    its wall time, posterior draws included), None for the model's own
    priors."""
    if prior not in ("expost", "expost_gmm", "expost_flow"):
        return None
    from apv_tpu_torch.eval.run import _prep_eval_batch, eval_arrays
    from apv_tpu_torch.sampling.run import (expost_prior_flow,
                                            expost_prior_gmm,
                                            expost_prior_moments,
                                            seed_generators)

    dev = resolve_device(device)
    images = eval_arrays(cfg, None, max_examples=2048)["image"]
    x_in = torch.from_numpy(_prep_eval_batch(cfg, images)[0]).to(dev)
    if prior == "expost":
        return expost_prior_moments(model, x_in)
    (gen,) = seed_generators(seed, 1, dev)
    if prior == "expost_flow":
        t0 = time.perf_counter()
        flow = expost_prior_flow(model, x_in, steps=flow_steps,
                                 generator=gen)
        nll = float(flow["flow_nll"])          # waits for the fit
        print(json.dumps({"expost_flow_fit_nll": nll,
                          "expost_flow_fit_s": time.perf_counter() - t0}))
        return flow
    return expost_prior_gmm(model, x_in, k=gmm_k, generator=gen)


def sample(config: str | Config = "mnist_vae", *,
           overrides: list[str] | None = None,
           checkpoint_dir: str | None = None, n: int = 64,
           mode: str = "mean", seed: int = 0,
           out_path: str | None = None, quality_n: int = 0,
           refine: int = 0, prior: str = "auto", gmm_k: int = 10,
           flow_steps: int = 2000, temperature: float = 1.0,
           device=None) -> torch.Tensor:
    """Decode n prior samples of a trained checkpoint; writes a PNG grid
    and returns the images [n, H, W, C] in [0, 1].

    ``prior``: 'auto' draws from the model's own prior (the trained flow's
    exact inverse; SIR from the adversarially shaped prior when a D exists,
    over the trained Gaussian base where there is one; else N(0, I) or the
    base); 'standard' forces N(0, I); 'expost' fits a diagonal Gaussian to
    the aggregate posterior over the test split, 'expost_gmm' a
    ``gmm_k``-component diagonal GMM, 'expost_flow' a RealNVP flow
    (``flow_steps`` fit steps). ``temperature`` T tempers a trained
    prior's base draw to N(0, T²I) (refused on any other prior).
    ``refine > 0`` runs that many MALA steps after SIR and prints the
    sampler diagnostics (SIR ESS, MALA acceptance). ``quality_n > 0`` also
    computes the sample-quality distances over that many samples and
    writes ``sample_quality.json``. Files of a prior other than 'auto' or
    a temperature other than 1 carry suffixes (``samples_expost_flow.png``,
    ``samples_T0.7.png``).
    """
    from apv_tpu_torch.sampling.run import generate_samples, save_image_grid

    if prior not in _PRIORS:
        raise ValueError(f"unknown prior {prior!r} "
                         "(auto|standard|expost|expost_gmm|expost_flow)")
    dev = resolve_device(device)
    cfg = _adopt_checkpoint_arch(_resolve(config, overrides), overrides,
                                 checkpoint_dir)
    state = _restore_state(cfg, checkpoint_dir, device=dev)
    model = state.model
    d = _d(state, cfg) if prior == "auto" else None
    prior_moments = _expost_prior(cfg, model, prior, gmm_k=gmm_k,
                                  flow_steps=flow_steps, seed=seed,
                                  device=dev)
    # 'auto' on a trained-prior checkpoint is that prior: the flow's
    # inverse (model_prior), or SIR/D over the Gaussian base (model_base)
    model_prior = cfg.model.prior == "flow" and prior == "auto"
    model_base = cfg.model.prior == "gaussian" and prior == "auto"
    images, diag = generate_samples(
        model, n, cfg.model.z_dim, cfg.model.likelihood,
        cfg.model.image_shape[2], d=d, seed=seed, mode=mode,
        refine_steps=refine, prior_moments=prior_moments,
        model_prior=model_prior, model_base=model_base,
        temperature=temperature, return_diagnostics=True)
    if diag:
        print(json.dumps({"sampler_diagnostics": diag}))
    # Non-default priors get suffixed file names, so an A/B over them never
    # overwrites the default protocol's files.
    suffix = "" if prior == "auto" else f"_{prior}"
    if temperature != 1.0:
        suffix += f"_T{temperature:g}"
    path = (out_path
            or Path(cfg.results_dir) / cfg.name / f"samples{suffix}.png")
    save_image_grid(images, path)
    if quality_n > 0:
        from apv_tpu_torch.eval.sample_quality import sample_quality
        metrics = sample_quality(cfg, model, d, n=quality_n, seed=seed,
                                 refine_steps=refine,
                                 prior_moments=prior_moments,
                                 model_prior=model_prior,
                                 model_base=model_base,
                                 temperature=temperature, device=dev)
        metrics["prior"] = prior
        _write_json(cfg, f"sample_quality{suffix}.json", metrics)
        print(json.dumps(metrics, indent=2))
    return images


def _load_named_model(cfg: Config, name: str, *, device=None):
    """(cfg_b, model_b, d_b) for a results-dir run name: the architecture
    from its saved config.json (else the preset of that name), the weights
    from its checkpoint."""
    cfg_b = _saved_config(cfg, name=name)
    if cfg_b is None:
        cfg_b = get_preset(name)
    state_b = _restore_state(cfg_b, device=device)
    return cfg_b, state_b.model, _d(state_b, cfg_b)


def ood_score(config: str | Config = "ood_suite", *,
              overrides: list[str] | None = None,
              checkpoint_dir: str | None = None, seed: int = 0,
              both: bool = False, device=None) -> dict:
    """Run the OOD suite for the configured dataset pair and write
    ``ood.json``. ``both=True`` also scores the reversed direction (with
    the ``ood.reverse_of`` checkpoint when set); ``score='model_ratio'``
    loads the ``ood.baseline_of`` checkpoint as the denominator."""
    from apv_tpu_torch.eval.ood import ood_both, ood_scores

    dev = resolve_device(device)
    cfg = _adopt_checkpoint_arch(_resolve(config, overrides), overrides,
                                 checkpoint_dir)
    state = _restore_state(cfg, checkpoint_dir, device=dev)
    d = _d(state, cfg)
    baseline = (None if cfg.ood.baseline_of is None
                else _load_named_model(cfg, cfg.ood.baseline_of, device=dev))
    if both:
        reverse = (None if cfg.ood.reverse_of is None
                   else _load_named_model(cfg, cfg.ood.reverse_of,
                                          device=dev))
        result = ood_both(cfg, state.model, d, seed=seed, baseline=baseline,
                          reverse=reverse, device=dev)
    else:
        result = ood_scores(cfg, state.model, d, seed=seed,
                            baseline=baseline, device=dev)
    _write_json(cfg, "ood.json", result)
    return result
