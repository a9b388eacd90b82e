"""Public entry points: ``train``, ``evaluate`` (config 4), ``sample``,
``visualize`` and ``ood_score`` (config 5), ``export_artifact`` and
``info`` (counterpart of ``apv_tpu/api.py``).

Each is config-driven (a preset name or Config, plus dot-path overrides),
reads the port's own checkpoints and the reference's orbax ones, writes
the port's own (``utils/checkpoint.py``), and writes its result next to
the run. Eval-side entry points adopt the
checkpoint's saved ``config.json``: its model, adversarial and data
sections (preprocessing must match training), then re-apply the caller's
overrides; ``train(resume=True)`` does the same when a checkpoint exists.
``info`` reads the results dir only: it loads no checkpoint, touches no
device and lists the steps of both checkpoint formats.

A checkpoint with a trained prior (``model.prior='flow'`` or
``'gaussian'``) samples and scores under it: ``sample``'s 'auto' prior is
the flow's exact inverse, or SIR over the Gaussian base with its D, at
``temperature``; ``ood_score`` scores under the checkpoint's own prior
through ``evaluate_nll``.

A biadversarial checkpoint's D is the ``{"latent", "pixel"}`` pair:
sampling and the likelihood scores read its latent D (``_d``), the OOD
suite gets the pair (``ood.score='pixel_d'`` reads the pixel D).

A checkpoint trained with ``train.ema_decay > 0`` is evaluated, sampled,
visualized, OOD-scored and exported through its EMA shadow (``_p``);
training's own validation reads the raw parameters.

``export_artifact`` writes a ``torch.export`` serving artifact
(``serving.py``), traced on the device that will serve it.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from apv_tpu_torch.utils.config import (Config, apply_overrides,
                                        config_from_dict, get_preset,
                                        refuse_hierarchical)
from apv_tpu_torch.utils.device import resolve_device

_PRIORS = ("auto", "standard", "expost", "expost_gmm", "expost_flow")


def _resolve(config: str | Config, overrides: list[str] | None) -> Config:
    cfg = get_preset(config) if isinstance(config, str) else config
    return apply_overrides(cfg, overrides or [])


def _decode_result_json(text: str):
    """A results-dir JSON payload, also in the legacy double-encoded form
    (a JSON string holding the JSON): ``_saved_config`` and ``info`` read
    through here."""
    d = json.loads(text)
    return json.loads(d) if isinstance(d, str) else d


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
    return config_from_dict(_decode_result_json(cfg_path.read_text()))


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
    """A result JSON in the run's dir, written by rank 0 alone under a
    process group (the logger's rule)."""
    from apv_tpu_torch.utils.logging import MetricLogger
    MetricLogger(Path(cfg.results_dir) / cfg.name).write_json(name, data)


def _p(state, cfg: Config):
    """The VAE eval-side entry points consume: the Polyak average when
    ``train.ema_decay`` is on and the state holds one, else the raw
    parameters (the reference's ``training/state.eval_params``)."""
    if cfg.train.ema_decay > 0.0 and state.ema_model is not None:
        return state.ema_model
    return state.model


def _d(state, cfg: Config, *, whole: bool = False):
    """The D eval-side entry points consume: None when the run is not
    adversarial, else the latent D (the pair's latent D under the
    biadversarial variant), or with ``whole`` the state's whole D (the OOD
    suite routes the latent and the pixel D itself)."""
    if not cfg.adversarial.enabled:
        return None
    if whole:
        return state.d
    from apv_tpu_torch.models import latent_d_params
    return latent_d_params(cfg.adversarial.variant, state.d)


def train(config: str | Config = "mnist_vae", *,
          overrides: list[str] | None = None, resume: bool = False,
          max_steps: int | None = None, trace_dir: str | None = None,
          overwrite: bool = False, device=None):
    """Train the configured model through ``train_loop``; returns the final
    TrainState. ``resume=True`` continues the newest checkpoint under
    ``<results_dir>/<name>/checkpoints``, rebuilt with that checkpoint's
    saved architecture, data section and train seed (the explicit
    overrides re-applied), but only when a checkpoint exists: a dir that
    holds only a crashed run's config.json leaves the preset as it is.
    ``overwrite=True`` lets a fresh run clear a results dir that holds a
    run. ``trace_dir`` writes a profiler trace of steps 10-15 of this
    invocation (``utils/logging.py``)."""
    from apv_tpu_torch.training.loop import train_loop
    from apv_tpu_torch.utils import checkpoint as ckpt

    cfg = _resolve(config, overrides)
    if resume and ckpt.latest_step(
            Path(cfg.results_dir) / cfg.name / "checkpoints") is not None:
        cfg = _adopt_checkpoint_arch(cfg, overrides)
    return train_loop(cfg, resume=resume, max_steps=max_steps,
                      trace_dir=trace_dir, overwrite=overwrite,
                      device=device)


_EVAL_PRIORS = ("model", "expost", "expost_gmm", "expost_flow")


def evaluate(config: str | Config = "iwae_eval", *,
             overrides: list[str] | None = None,
             checkpoint_dir: str | None = None, dataset: str | None = None,
             k: int | None = None, per_sample: bool = False,
             activity: bool = True, prior: str = "model", gmm_k: int = 10,
             flow_steps: int = 2000, device=None) -> dict:
    """IWAE-k test NLL and bits/dim of a trained checkpoint over the first
    ``eval.max_examples`` test images of ``dataset`` (default the config's).

    ``prior``: 'model' scores under the checkpoint's own prior; 'expost',
    'expost_gmm' (``gmm_k`` components) and 'expost_flow' (``flow_steps``
    fit steps) under an ex-post prior fitted to the first 2,048 images of
    the train split, preprocessed as training saw them: an exact density,
    no log-partition estimate. ``activity`` adds the active-units report
    (``posterior_activity``). Writes ``eval.json`` (``eval_<prior>.json``
    for an ex-post prior) without ``per_sample``, which only the returned
    dict holds.
    """
    refuse_hierarchical(_resolve(config, overrides).model, "evaluate")
    from apv_tpu_torch.eval.run import (eval_arrays, evaluate_nll,
                                        posterior_activity)

    if prior not in _EVAL_PRIORS:
        raise ValueError(f"unknown prior {prior!r} "
                         "(model|expost|expost_gmm|expost_flow)")
    dev = resolve_device(device)
    cfg = _adopt_checkpoint_arch(_resolve(config, overrides), overrides,
                                 checkpoint_dir)
    state = _restore_state(cfg, checkpoint_dir, device=dev)
    model = _p(state, cfg)
    prior_moments = _expost_prior(cfg, model, prior, gmm_k=gmm_k,
                                  flow_steps=flow_steps, split="train",
                                  device=dev)
    images = eval_arrays(cfg, dataset,
                         max_examples=cfg.eval.max_examples)["image"]
    result = evaluate_nll(cfg, model, _d(state, cfg), images, k=k,
                          per_sample=per_sample,
                          prior_moments=prior_moments, device=dev)
    if activity:
        result.update(posterior_activity(cfg, model, images, device=dev))
    out = {k_: v for k_, v in result.items() if k_ != "per_sample"}
    # an ex-post prior's file never overwrites the model prior's eval.json
    suffix = "" if prior == "model" else f"_{prior}"
    _write_json(cfg, f"eval{suffix}.json", out)
    return result


def info(name: str | None = None, *, results_dir: str = "results") -> dict:
    """The results dir, read from the files alone (no checkpoint is loaded
    and no device touched). Without ``name``: one summary a run (config
    highlights, newest checkpoint step). With ``name``: that run's summary,
    its checkpoint steps on disk, ``best.json``, its result files
    (``eval*.json``, ``ood*.json``, ``sample_quality*.json``) and the last
    ``metrics.jsonl`` record."""
    from apv_tpu_torch.utils.checkpoint import _steps

    root = Path(results_dir)

    def _read(p: Path):
        try:
            return _decode_result_json(p.read_text())
        except (OSError, json.JSONDecodeError):
            return None

    def _summary(run: Path) -> dict:
        cfg = _read(run / "config.json") or {}
        model, adv = cfg.get("model", {}), cfg.get("adversarial", {})
        steps = _steps(run / "checkpoints")
        return {
            "name": run.name,
            "family": model.get("family"),
            "z_dim": model.get("z_dim"),
            "likelihood": model.get("likelihood"),
            "adversarial": (adv.get("variant") if adv.get("enabled")
                            else None),
            "dataset": cfg.get("data", {}).get("dataset"),
            "train_steps": cfg.get("train", {}).get("steps"),
            "latest_checkpoint": steps[-1] if steps else None,
        }

    if name is None:
        runs = sorted(p for p in root.iterdir()
                      if p.is_dir() and (p / "config.json").exists()) \
            if root.exists() else []
        return {"results_dir": str(root),
                "runs": [_summary(r) for r in runs]}

    run = root / name
    if not (run / "config.json").exists():
        raise FileNotFoundError(
            f"no run named {name!r} under {root} (no config.json)")
    out = _summary(run)
    out["checkpoint_steps"] = _steps(run / "checkpoints")
    out["best"] = _read(run / "best.json")
    result_files = ["eval.json", "ood.json", "sample_quality.json"]
    result_files += sorted(
        p.name for p in run.glob("*.json")
        if (p.name.startswith(("eval_", "sample_quality_", "ood_"))
            and p.name not in result_files))
    for f in result_files:
        data = _read(run / f)
        if data is not None:
            out[f.removesuffix(".json")] = data
    metrics = run / "metrics.jsonl"
    if metrics.exists():
        lines = [ln for ln in metrics.read_text().splitlines() if ln.strip()]
        if lines:
            try:
                out["last_metrics"] = json.loads(lines[-1])
            except json.JSONDecodeError:
                pass
    return out


def _expost_prior(cfg: Config, model, prior: str, *, gmm_k: int = 10,
                  flow_steps: int = 2000, seed: int = 0,
                  split: str = "test", device=None):
    """Fit the requested ex-post prior on the first 2,048 images of
    ``split``, preprocessed as training saw them: ``(mean, var)`` for
    'expost', ``(log_w, means, vars)`` for 'expost_gmm', a flow params
    dict for 'expost_flow' (``flow_steps`` fit steps; prints the fit's
    final NLL and its wall time, posterior draws included), None for the
    model's own priors. ``sample`` fits the test split (the recorded A/B
    protocol); ``evaluate`` fits the train split, binarized as the train
    loop binarizes it, since a prior fitted on the images it then scores
    would leak."""
    if prior not in ("expost", "expost_gmm", "expost_flow"):
        return None
    from apv_tpu_torch.eval.run import _prep_eval_batch, eval_arrays
    from apv_tpu_torch.sampling.run import (expost_prior_flow,
                                            expost_prior_gmm,
                                            expost_prior_moments,
                                            seed_generators)

    dev = resolve_device(device)
    if split == "test":
        images = eval_arrays(cfg, None, max_examples=2048)["image"]
    else:
        from apv_tpu_torch.data.datasets import load_dataset
        from apv_tpu_torch.data.preprocess import static_binarize
        images, _ = load_dataset(cfg.data.dataset, split,
                                 data_dir=cfg.data.data_dir,
                                 synthetic_size=cfg.data.synthetic_size)
        if cfg.data.binarize:
            # the train loop's binarization (training/loop.py)
            images = static_binarize(images, seed=cfg.train.seed)
        images = images[:2048]
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
    refuse_hierarchical(_resolve(config, overrides).model, "sample")
    from apv_tpu_torch.sampling.run import generate_samples, save_image_grid

    if prior not in _PRIORS:
        raise ValueError(f"unknown prior {prior!r} "
                         "(auto|standard|expost|expost_gmm|expost_flow)")
    dev = resolve_device(device)
    cfg = _adopt_checkpoint_arch(_resolve(config, overrides), overrides,
                                 checkpoint_dir)
    state = _restore_state(cfg, checkpoint_dir, device=dev)
    model = _p(state, cfg)
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


_VISUALS = ("reconstruct", "interpolate", "latent")


def visualize(config: str | Config = "mnist_vae", *,
              overrides: list[str] | None = None,
              checkpoint_dir: str | None = None, what: str = "reconstruct",
              n: int = 8, steps: int = 8, seed: int = 0, mode: str = "mean",
              out_path: str | None = None, refine: int = 0, device=None):
    """Reconstruction and interpolation grids and the latent scatter of a
    trained checkpoint, written as PNGs next to the run.

    ``what='reconstruct'``: the first n test images over their q(z|x)
    sample's decodings (``reconstructions.png``; returns the decodings).
    ``'interpolate'``: n pairs of test images, slerp between their
    posterior means, a row of ``steps`` images a pair
    (``interpolation.png``; returns [n, steps, H, W, C]). ``'latent'``:
    the aggregate posterior against the priors on its top-2 PCs
    (``latent_scatter.png``, at least 256 points; ``refine`` MALA steps on
    the shaped-prior draws, refused without a latent D; returns the
    projected clouds)."""
    refuse_hierarchical(_resolve(config, overrides).model, "visualize")
    from apv_tpu_torch.eval.run import _prep_eval_batch, eval_arrays
    from apv_tpu_torch.sampling.run import (latent_interpolate,
                                            reconstruct_images,
                                            save_image_grid)

    if what not in _VISUALS:
        raise ValueError(f"unknown visualization {what!r} "
                         "(reconstruct|interpolate|latent)")
    dev = resolve_device(device)
    cfg = _adopt_checkpoint_arch(_resolve(config, overrides), overrides,
                                 checkpoint_dir)
    if what == "latent" and not cfg.adversarial.enabled and refine > 0:
        raise ValueError("refine applies to the adversarially-shaped "
                         "prior; this model has no latent discriminator — "
                         "drop --refine")
    state = _restore_state(cfg, checkpoint_dir, device=dev)
    model = _p(state, cfg)
    need = {"latent": max(n, 256), "reconstruct": n}.get(what, 2 * n)
    images = eval_arrays(cfg, None, max_examples=need)["image"][:need]
    x_np, levels = _prep_eval_batch(cfg, images)
    x_in = torch.from_numpy(x_np).to(dev)
    run_dir = Path(cfg.results_dir) / cfg.name
    lik, chans = cfg.model.likelihood, cfg.model.image_shape[2]

    if what == "latent":
        from apv_tpu_torch.sampling.latent_viz import (latent_scatter_data,
                                                       save_latent_scatter)
        data = latent_scatter_data(model, x_in, cfg.model.z_dim,
                                   d=_d(state, cfg),
                                   refine_steps=refine,
                                   model_prior=cfg.model.prior, seed=seed)
        save_latent_scatter(data, out_path or run_dir / "latent_scatter.png")
        return data
    if what == "reconstruct":
        recon = reconstruct_images(model, x_in, lik, chans, seed=seed,
                                   mode=mode)
        grid = np.concatenate([np.asarray(levels, np.float32),
                               recon.cpu().numpy()])
        save_image_grid(grid, out_path or run_dir / "reconstructions.png",
                        cols=n)
        return recon
    if len(x_in) < 2 * n:
        raise ValueError(
            f"interpolate needs 2*n={2 * n} test images for n={n} pairs; "
            f"the test split has {len(x_in)} — lower n or raise "
            "data.synthetic_size / eval.max_examples")
    frames = latent_interpolate(model, x_in[:n], x_in[n:2 * n], steps, lik,
                                chans)
    save_image_grid(frames.reshape((-1,) + tuple(frames.shape[2:])),
                    out_path or run_dir / "interpolation.png", cols=steps)
    return frames


def _load_named_model(cfg: Config, name: str, *, device=None):
    """(cfg_b, model_b, d_b) for a results-dir run name: the architecture
    from its saved config.json (else the preset of that name), the weights
    from its checkpoint; d_b is the whole D (the OOD suite routes it)."""
    cfg_b = _saved_config(cfg, name=name)
    if cfg_b is None:
        cfg_b = get_preset(name)
    state_b = _restore_state(cfg_b, device=device)
    return cfg_b, _p(state_b, cfg_b), _d(state_b, cfg_b, whole=True)


def ood_score(config: str | Config = "ood_suite", *,
              overrides: list[str] | None = None,
              checkpoint_dir: str | None = None, seed: int = 0,
              both: bool = False, device=None) -> dict:
    """Run the OOD suite for the configured dataset pair and write
    ``ood.json``. ``both=True`` also scores the reversed direction (with
    the ``ood.reverse_of`` checkpoint when set); ``score='model_ratio'``
    loads the ``ood.baseline_of`` checkpoint as the denominator;
    ``score='pixel_d'`` scores with a biadversarial checkpoint's pixel D."""
    refuse_hierarchical(_resolve(config, overrides).model, "ood_score")
    from apv_tpu_torch.eval.ood import ood_both, ood_scores

    dev = resolve_device(device)
    cfg = _adopt_checkpoint_arch(_resolve(config, overrides), overrides,
                                 checkpoint_dir)
    state = _restore_state(cfg, checkpoint_dir, device=dev)
    d = _d(state, cfg, whole=True)
    baseline = (None if cfg.ood.baseline_of is None
                else _load_named_model(cfg, cfg.ood.baseline_of, device=dev))
    if both:
        reverse = (None if cfg.ood.reverse_of is None
                   else _load_named_model(cfg, cfg.ood.reverse_of,
                                          device=dev))
        result = ood_both(cfg, _p(state, cfg), d, seed=seed,
                          baseline=baseline, reverse=reverse, device=dev)
    else:
        result = ood_scores(cfg, _p(state, cfg), d, seed=seed,
                            baseline=baseline, device=dev)
    _write_json(cfg, "ood.json", result)
    return result


_WHATS = ("sampler", "scorer")


def export_artifact(config: str | Config = "mnist_vae", *,
                    overrides: list[str] | None = None,
                    checkpoint_dir: str | None = None,
                    what: str = "sampler", out_path: str | None = None,
                    quantize: str | None = None, refine: int = 0,
                    prior: str = "auto", gmm_k: int = 10,
                    flow_steps: int = 2000, temperature: float = 1.0,
                    device=None) -> Path:
    """Export a serving artifact of a trained checkpoint, weights baked in
    (``serving.export_sampler`` or ``export_scorer``), to ``out_path``
    (default ``<results_dir>/<name>/<what>.pt2``); returns its path. The
    artifact runs on ``device``, where it is traced (default: the card).

    The sampler: ``prior='auto'`` keeps the model's own (shaped or
    trained) prior, with ``refine`` MALA steps on the shaped one;
    'standard' forces N(0, I); 'expost', 'expost_gmm' (``gmm_k``
    components) and 'expost_flow' (``flow_steps`` fit steps) bake in a
    prior fitted to the test split at export time. ``temperature`` tempers
    a trained prior's base draw; ``quantize='int8'`` stores int8 kernels.
    The scorer takes none of these and refuses each (``temperature`` too,
    which the reference ignores without a word)."""
    refuse_hierarchical(_resolve(config, overrides).model, "export_artifact")
    from apv_tpu_torch import serving

    if what not in _WHATS:
        raise ValueError(f"unknown artifact {what!r} (sampler|scorer)")
    if prior not in _PRIORS:
        raise ValueError(f"unknown prior {prior!r} "
                         "(auto|standard|expost|expost_gmm|expost_flow)")
    if what == "scorer":
        if refine:
            raise ValueError("refine is sampler-only (MALA on the shaped "
                             "prior); the scorer draws no prior samples")
        if prior != "auto":
            raise ValueError("prior is sampler-only: the scorer evaluates "
                             "the model's own (learned) prior density")
        if quantize is not None:
            raise ValueError("quantize is sampler-only: a silently "
                             "full-precision scorer artifact would "
                             "masquerade as quantized")
        if temperature != 1.0:
            raise ValueError("temperature is sampler-only: the scorer "
                             "evaluates the model's own prior density at "
                             "its fitted scale")
    dev = resolve_device(device)
    cfg = _adopt_checkpoint_arch(_resolve(config, overrides), overrides,
                                 checkpoint_dir)
    state = _restore_state(cfg, checkpoint_dir, device=dev)
    model = _p(state, cfg)
    out = out_path or Path(cfg.results_dir) / cfg.name / f"{what}.pt2"
    if what == "scorer":
        return serving.export_scorer(cfg, model, out, d=_d(state, cfg),
                                     device=dev)
    prior_moments = _expost_prior(cfg, model, prior, gmm_k=gmm_k,
                                  flow_steps=flow_steps, device=dev)
    return serving.export_sampler(
        cfg, model, _d(state, cfg) if prior == "auto" else None, out,
        quantize=quantize, refine_steps=refine, prior_moments=prior_moments,
        force_standard=prior == "standard", temperature=temperature,
        device=dev)
