"""Serving: the prior sampler and the per-sample ELBO scorer, in process
and as exported artifacts (counterpart of ``apv_tpu/serving.py``).

In process (``make_sampler``, ``make_scorer``; the reference's
``_sampler_fn`` and ``_scorer_fn``): each under the checkpoint's own
prior, N(0, I), the trained flow or Gaussian base, and the adversarial D.

Exported (``export_sampler``, ``export_scorer``, ``load_exported``): a
``torch.export`` program saved as a ``.pt2`` file, the weights baked in
as its buffers, optionally as symmetric per-output-channel int8
(``quantize_params_int8``), each multiply back to float32 in the graph.

* The sampler artifact maps a ``seed`` (an int64 scalar) to
  ``[cfg.eval.batch_size, H, W, C]`` images in [0, 1]. Its draws come from
  a ``SeedStream`` (Philox keyed by the seed, in the graph), and MALA's
  gradient is written out in closed form: ``torch.export`` traces neither
  a ``torch.Generator`` nor ``autograd.grad``.
* The scorer artifact maps images ``x`` [b, H, W, C] and a ``seed`` to the
  ELBO [b]; b is symbolic unless ``polymorphic_batch=False``. It calls the
  four forward kernels of its path as custom ops (``ops/export_ops.py``),
  its reparameterization keyed by (seed, 0). Under a latent D, log Z is
  estimated at export time and baked in.

An artifact keeps the device of the example tensors it was traced with
(factory ops in the graph record it): the reference lowers one artifact
for the TPU and the CPU, the port traces on the device that will serve.
A trace on the card launches the kernels; one on the CPU runs their plain
versions. The ``seed`` input is a CPU tensor on either: the reparam
kernel reads its key on the host. Loading needs this package's custom ops
registered, which ``load_exported`` does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import torch
import torch.nn as nn
import torch.utils._pytree as pytree

from apv_tpu_torch import ops
from apv_tpu_torch.core.distributions import standard_gaussian_logpdf
from apv_tpu_torch.data.preprocess import normalize_center
from apv_tpu_torch.training.losses import elbo_terms, recon_log_likelihood
from apv_tpu_torch.utils.config import Config
from apv_tpu_torch.utils.device import resolve_device


def _check_sampler(cfg: Config, use_adv: bool, refine_steps: int,
                   prior_moments, temperature: float,
                   force_standard: bool = False) -> None:
    """The refusals the reference's sampler makes: a temperature off a
    trained prior, a refinement without a latent D or under an ex-post
    prior."""
    trained_prior = cfg.model.prior in ("flow", "gaussian")
    if temperature != 1.0 and (not trained_prior or force_standard
                               or prior_moments is not None):
        raise ValueError("temperature applies to the model's own trained "
                         "prior (model.prior='flow'/'gaussian'); this "
                         "artifact would sample a different prior")
    if refine_steps > 0 and (not use_adv or prior_moments is not None):
        raise ValueError("refine_steps applies to the adversarially-shaped "
                         "prior; this artifact would sample "
                         + ("the ex-post prior (drawn exactly)"
                            if prior_moments is not None
                            else "a checkpoint with no latent "
                                 "discriminator")
                         + " — a silently-dropped refinement would "
                         "misreport its sampling protocol")


def _prior_flags(cfg: Config, use_adv: bool, prior_moments,
                 force_standard: bool = False) -> tuple[bool, bool]:
    """(model_prior, model_base) of ``generate_samples``: the trained
    flow or Gaussian drawn exactly, or SIR/MALA over the Gaussian base."""
    own = (prior_moments is None and not force_standard
           and cfg.model.prior in ("flow", "gaussian"))
    model_base = own and use_adv and cfg.model.prior == "gaussian"
    return own and not model_base, model_base


def make_sampler(cfg: Config, model, d=None, refine_steps: int = 0,
                 prior_moments=None, *, temperature: float = 1.0,
                 device=None) -> Callable:
    """Build ``fn(seed: int) -> images [cfg.eval.batch_size, H, W, C]`` in
    [0, 1] (the likelihood's mean).

    The latent draw is the ex-post prior ``prior_moments`` when given,
    else SIR (+ ``refine_steps`` of MALA) from the shaped prior when the
    model is adversarial and ``d`` is given (over the trainable base for
    ``model.prior='gaussian'``), else the model's own prior: the trained
    flow or Gaussian base, or N(0, I). ``temperature`` T tempers a trained
    prior's base draw to N(0, T²I). The latent draw and the pixel noise
    take distinct generators derived from the seed
    (``sampling/run.generate_samples``). Refused as the reference refuses:
    ``temperature`` other than 1 on any other prior, ``refine_steps``
    without a latent D or with an ex-post prior.
    """
    from apv_tpu_torch.sampling.run import generate_samples
    dev = resolve_device(device)
    model = model.to(dev)
    use_adv = cfg.adversarial.enabled and d is not None
    _check_sampler(cfg, use_adv, refine_steps, prior_moments, temperature)
    d_use = d.to(dev) if use_adv else None
    model_prior, model_base = _prior_flags(cfg, use_adv, prior_moments)

    def fn(seed: int) -> torch.Tensor:
        return generate_samples(model, cfg.eval.batch_size, cfg.model.z_dim,
                                cfg.model.likelihood,
                                cfg.model.image_shape[2], d=d_use,
                                seed=int(seed), mode="mean",
                                refine_steps=refine_steps,
                                prior_moments=prior_moments,
                                model_prior=model_prior,
                                model_base=model_base,
                                temperature=temperature)

    return fn


def _prior_correction(cfg: Config, model, z: torch.Tensor) -> torch.Tensor:
    """A trained prior's log p_θ(z) − log N(z; 0, I): the exact swap of the
    analytic KL's N(0, I) for the model's own prior on the same z."""
    return model.prior_logpdf(z) - torch.sum(standard_gaussian_logpdf(z),
                                             dim=-1)


def make_scorer(cfg: Config, model, d=None, log_z: float = 0.0, *,
                device=None) -> Callable:
    """Build ``fn(x, *, generator=None, eps=None, key=None) -> ELBO [B]``
    (nats).

    ``x`` is images [B,H,W,C] in [0,1] on the scorer's device. The input
    convention mirrors eval: binarized configs feed x straight through;
    continuous configs center the encoder input to [-1,1] while the
    likelihood scores the raw [0,1] levels. A trained prior
    (``model.prior``) replaces N(0, I) on the same z: + log p_θ(z) −
    log N(z; 0, I). Adversarial checkpoints (``d`` given) score under the
    learned prior: + D(z) − log Z (``log_z`` estimated under the same
    base). ``eps`` (CPU only) injects the reparameterization noise;
    ``key`` draws it from the Philox stream (seed, offset) through the
    ``apv::reparam`` op, as a scorer artifact draws it with (seed, 0).
    """
    dev = resolve_device(device)
    model = model.to(dev)
    use_adv = cfg.adversarial.enabled and d is not None
    if use_adv:
        d = d.to(dev)

    def fn(x: torch.Tensor, *, generator: torch.Generator | None = None,
           eps: torch.Tensor | None = None,
           key: tuple[int, int] | None = None) -> torch.Tensor:
        with torch.inference_mode():
            x_in = x if cfg.data.binarize else normalize_center(x)
            if key is None:
                recon, kl, z = elbo_terms(model.encode, model.decode, x_in,
                                          x, cfg.model.likelihood,
                                          generator=generator, eps=eps)
            else:
                from apv_tpu_torch.ops.export_ops import reparam
                mean, logvar = model.encode(x_in)
                z = reparam(mean, logvar, 1, torch.tensor(key))[0]
                recon = recon_log_likelihood(x, model.decode(z),
                                             cfg.model.likelihood)
                kl = ops.kl_standard(mean, logvar)
            elbo = recon - kl
            if cfg.model.prior in ("flow", "gaussian"):
                elbo = elbo + _prior_correction(cfg, model, z)
            if use_adv:
                elbo = elbo + d(z) - log_z
            return elbo

    return fn


# ---------------------------------------------------------------------------
# int8 weight-only quantization
# ---------------------------------------------------------------------------

_Q8 = "__q8__"                  # marker key of a quantized tensor


def _kernel_axes(net: nn.Module) -> dict[str, int]:
    """The tensors that come from a flax ``kernel`` leaf (the weights of
    Dense, SNDense, Conv and ConvTranspose), each with its output axis: 0
    in torch's layouts, 1 for ConvTranspose's (in, out, kh, kw). The
    flow's ``w1``/``w2``/``w3`` are not kernel leaves."""
    from apv_tpu_torch.models.common import Conv, ConvTranspose2x, Dense
    axes = {}
    for prefix, mod in net.named_modules():
        if isinstance(mod, (Dense, Conv, ConvTranspose2x)):
            name = f"{prefix}.weight" if prefix else "weight"
            axes[name] = 1 if isinstance(mod, ConvTranspose2x) else 0
    return axes


def _tensors(net: nn.Module) -> dict[str, torch.Tensor]:
    """Every parameter and buffer of ``net`` by name, detached."""
    out = {n: p.detach() for n, p in net.named_parameters()}
    out.update((n, b.detach()) for n, b in net.named_buffers())
    return out


def quantize_params_int8(net: nn.Module, min_size: int = 4096) -> dict:
    """Weight-only int8 post-training quantization of a module's kernel
    tensors (reference ``quantize_params_int8``): symmetric scales per
    output channel, s = max|w|/127 (1 where the channel is zero), q =
    clip(round(w/s), ±127). Kernels of 2+ dims and at least ``min_size``
    elements become ``{"__q8__": int8, "scale": f32}``, the scale shaped
    to broadcast over the output axis; biases, norm scales, small kernels,
    the priors' tensors and buffers stay float. Returns every parameter
    and buffer by name."""
    axes = _kernel_axes(net)
    out: dict = {}
    for name, t in _tensors(net).items():
        axis = axes.get(name)
        if axis is None or t.dim() < 2 or t.numel() < min_size:
            out[name] = t
            continue
        w = t.to(torch.float32)
        others = tuple(i for i in range(w.dim()) if i != axis)
        s = torch.amax(torch.abs(w), dim=others, keepdim=True) / 127.0
        s = torch.where(s == 0, torch.ones_like(s), s)
        q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
        out[name] = {_Q8: q, "scale": s}
    return out


def _is_q(x) -> bool:
    return isinstance(x, dict) and _Q8 in x


def dequantize_params(tree: dict) -> dict:
    """Inverse of ``quantize_params_int8``: q·scale in float32 (runs in
    the traced graph)."""
    return {name: (x[_Q8].to(torch.float32) * x["scale"]
                   if _is_q(x) else x) for name, x in tree.items()}


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


def _channels_last(t: torch.Tensor) -> bool:
    return (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


class _Artifact(nn.Module):
    """The exported program's root: ``net``'s tensors as its buffers (int8
    and scales where quantized), put back by ``functional_call`` on each
    call, so the multiply that dequantizes runs in the graph. ``net`` is
    held outside the module tree: only these buffers are saved.

    The buffers are stored contiguous (``torch.export.save`` writes a
    tensor whole only when it covers its storage in the default layout);
    the models' channels_last conv weights get that layout back in the
    graph, so the convolutions run as they do in process."""

    def __init__(self, net: nn.Module, quantize: str | None):
        super().__init__()
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r} (int8)")
        self.__dict__["net"] = net
        tensors = _tensors(net)
        self.channels_last = [n for n, t in tensors.items()
                              if _channels_last(t)]
        tree = quantize_params_int8(net) if quantize == "int8" else tensors
        self.plain, self.quant = [], []
        for i, (name, x) in enumerate(tree.items()):
            if _is_q(x):
                self.register_buffer(f"q{i}", _contiguous(x[_Q8]))
                self.register_buffer(f"s{i}", _contiguous(x["scale"]))
                self.quant.append((name, f"q{i}", f"s{i}"))
            else:
                self.register_buffer(f"t{i}", _contiguous(x))
                self.plain.append((name, f"t{i}"))

    def forward(self, *args):
        tensors = {name: getattr(self, key) for name, key in self.plain}
        tensors.update(dequantize_params(
            {name: {_Q8: getattr(self, q), "scale": getattr(self, s)}
             for name, q, s in self.quant}))
        for name in self.channels_last:
            tensors[name] = tensors[name].contiguous(
                memory_format=torch.channels_last)
        return torch.func.functional_call(self.net, tensors, args)


class _SamplerNet(nn.Module):
    """seed -> images: ``generate_samples`` on a ``SeedStream``, the
    ex-post prior's tensors (any of its three forms) as buffers."""

    def __init__(self, cfg: Config, model, d, refine_steps: int,
                 prior_moments, force_standard: bool, temperature: float):
        super().__init__()
        self.cfg, self.model, self.d = cfg, model, d
        self.refine_steps, self.temperature = refine_steps, temperature
        self.model_prior, self.model_base = _prior_flags(
            cfg, d is not None, prior_moments, force_standard)
        # None (the model's own prior) flattens to one leaf, a None buffer
        leaves, self.prior_spec = pytree.tree_flatten(prior_moments)
        self.n_prior = len(leaves)
        for i, t in enumerate(leaves):
            self.register_buffer(f"prior{i}", t)

    def forward(self, seed: torch.Tensor) -> torch.Tensor:
        from apv_tpu_torch.sampling.run import SeedStream, generate_samples
        cfg = self.cfg
        dev = next(self.model.parameters()).device
        prior_moments = pytree.tree_unflatten(
            [getattr(self, f"prior{i}") for i in range(self.n_prior)],
            self.prior_spec)
        return generate_samples(
            self.model, cfg.eval.batch_size, cfg.model.z_dim,
            cfg.model.likelihood, cfg.model.image_shape[2], d=self.d,
            mode="mean", refine_steps=self.refine_steps,
            prior_moments=prior_moments, model_prior=self.model_prior,
            model_base=self.model_base, temperature=self.temperature,
            stream=SeedStream(seed, dev))


class _ScorerNet(nn.Module):
    """(x, seed) -> ELBO [b]: ``make_scorer``'s function on the custom ops
    (``ops/export_ops.py``), its reparameterization keyed by (seed, 0)."""

    def __init__(self, cfg: Config, model, d, log_z: float):
        super().__init__()
        self.cfg, self.model, self.d, self.log_z = cfg, model, d, log_z

    def forward(self, x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
        from apv_tpu_torch.ops.dispatch import disc_logistic_mix_recon_ll
        from apv_tpu_torch.training.losses import \
            decoder_output_to_likelihood_params
        cfg, apv = self.cfg, torch.ops.apv
        x_in = x if cfg.data.binarize else normalize_center(x)
        mean, logvar = self.model.encode(x_in)
        key = torch.stack([seed, torch.zeros_like(seed)])
        z = apv.reparam(mean, logvar, 1, key)[0]
        lik = cfg.model.likelihood
        params = decoder_output_to_likelihood_params(
            self.model.decode(z), lik, cfg.model.image_shape[2])
        if lik == "bernoulli":
            recon = apv.bernoulli(x, params[0], 1)
        elif lik == "disc_logistic_mix":
            recon = disc_logistic_mix_recon_ll(x, *params)
        else:
            recon = apv.disc_logistic(x, params[0], params[1], 1.0 / 255.0,
                                      1)
        elbo = recon - apv.kl(mean, logvar)
        if cfg.model.prior in ("flow", "gaussian"):
            elbo = elbo + _prior_correction(cfg, self.model, z)
        if self.d is not None:
            elbo = elbo + self.d(z) - self.log_z
        return elbo


def _seed_example() -> torch.Tensor:
    return torch.tensor(0, dtype=torch.int64)


def _export(root: nn.Module, args: tuple, out_path: str | Path,
            dynamic_shapes=None) -> Path:
    """Trace ``root`` on ``args`` (``torch.export``, non-strict) and save
    the program to ``out_path``."""
    with torch.no_grad():
        ep = torch.export.export(root, args, dynamic_shapes=dynamic_shapes,
                                 strict=False)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(ep, out_path)
    return out_path


def export_sampler(cfg: Config, model, d, out_path: str | Path, *,
                   quantize: str | None = None, refine_steps: int = 0,
                   prior_moments=None, force_standard: bool = False,
                   temperature: float = 1.0, device=None) -> Path:
    """Export the batched generation path, weights baked in, as a ``.pt2``
    file: ``seed`` (an int64 CPU scalar) -> ``[cfg.eval.batch_size, H, W,
    C]`` in [0, 1] on ``device`` (default: the card).

    ``d`` (the latent D) gives SIR from the shaped prior, and
    ``refine_steps`` MALA steps on it unrolled into the graph;
    ``prior_moments`` (an ex-post Gaussian, GMM or flow) and
    ``force_standard`` (N(0, I)) replace the model's own prior;
    ``temperature`` tempers a trained prior's base draw. Refused as
    ``make_sampler`` refuses. ``quantize='int8'`` stores the kernel
    tensors as int8 (``quantize_params_int8``)."""
    from apv_tpu_torch.models.discriminator import LatentDiscriminator
    dev = resolve_device(device)
    use_adv = cfg.adversarial.enabled and d is not None
    _check_sampler(cfg, use_adv, refine_steps, prior_moments, temperature,
                   force_standard)
    if use_adv and not isinstance(d, LatentDiscriminator):
        raise TypeError("export_sampler: d is the latent D "
                        "(models.latent_d_params)")
    if prior_moments is not None:
        prior_moments = pytree.tree_map(lambda t: t.to(dev), prior_moments)
    net = _SamplerNet(cfg, model.to(dev), d.to(dev) if use_adv else None,
                      refine_steps, prior_moments, force_standard,
                      temperature).eval()
    return _export(_Artifact(net, quantize), (_seed_example(),), out_path)


def export_scorer(cfg: Config, model, out_path: str | Path, *, d=None,
                  polymorphic_batch: bool = True, device=None) -> Path:
    """Export the per-sample ELBO scorer as a ``.pt2`` file: ``x`` [b, H,
    W, C] in [0, 1] on ``device`` (default: the card) and ``seed`` (an
    int64 CPU scalar) -> ELBO [b]. The batch axis is a
    ``torch.export.Dim`` (one artifact serves any b ≥ 1), or
    ``cfg.eval.batch_size`` with ``polymorphic_batch=False``.

    With ``d`` (an adversarial checkpoint's latent D) the artifact scores
    under the learned prior; log Z is estimated here
    (``estimate_log_partition``, seed 0, over the trainable Gaussian base
    where the model has one) and baked in as a constant."""
    from apv_tpu_torch.ops import export_ops  # noqa: F401  registers the ops
    dev = resolve_device(device)
    model = model.to(dev)
    use_adv = cfg.adversarial.enabled and d is not None
    log_z = 0.0
    if use_adv:
        from apv_tpu_torch.eval.iwae_eval import estimate_log_partition
        d = d.to(dev)
        base_from = (model.prior_sample_from
                     if cfg.model.prior == "gaussian" else None)
        with torch.no_grad():
            log_z = float(estimate_log_partition(d, cfg.model.z_dim,
                                                 seed=0, device=dev,
                                                 base_from=base_from))
    net = _ScorerNet(cfg, model, d if use_adv else None, log_z).eval()
    b = cfg.eval.batch_size
    x = torch.zeros((max(b, 2),) + tuple(cfg.model.image_shape),
                    device=dev)
    dynamic = ({"args": ({0: torch.export.Dim("batch", min=1)}, None)}
               if polymorphic_batch else None)
    return _export(_Artifact(net, None), (x, _seed_example()), out_path,
                   dynamic)


def load_exported(path: str | Path) -> nn.Module:
    """A saved artifact as a callable module: ``fn(seed)`` (sampler) or
    ``fn(x, seed)`` (scorer), ``seed`` an int64 CPU scalar tensor. The
    package's custom ops are registered first."""
    from apv_tpu_torch.ops import export_ops  # noqa: F401
    return torch.export.load(Path(path)).module()
