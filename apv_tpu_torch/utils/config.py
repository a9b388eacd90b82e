"""Config system: one frozen dataclass tree + five named presets
(SURVEY.md §2.6 "Config/flag system", §5).

The PyTorch port's own copy of ``apv_tpu/utils/config.py``: the port
imports nothing of ``apv_tpu``, and ``tests/test_torch_config.py`` holds
the two copies' presets and overrides equal.

The presets match the five reference configs from BASELINE.json verbatim
(SURVEY.md §0.1): mnist_vae, mnist_advprior, cifar_advprior_resnet,
iwae_eval, ood_suite. CLI overrides use dot paths: ``--set train.lr=3e-4``.

[I]-flagged reference unknowns (SURVEY.md §7 risk R2) are config knobs so
they can be snapped to the real reference without rework: the adversarial
loss variant (``adversarial.variant``), ``n_critic``, the OOD score
definition (``ood.score``), architecture sizes.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    family: str = "conv"                       # conv | resnet
    z_dim: int = 40
    widths: tuple[int, ...] = (32, 64)
    blocks_per_stage: int = 2                  # resnet only
    dense: int = 512                           # conv only
    # bernoulli | discretized_logistic | disc_logistic_mix. The reference's
    # likelihood is the SINGLE discretized logistic [B]; the K-component
    # mixture is the literature-standard quality upgrade (same 256-level
    # grid — bits/dim directly comparable), offered as an extension knob.
    # Gate verdict on SYNTHETIC data: fails both quality horizons
    # (RESULTS.md roofline §3c) — re-gate on real CIFAR-10 before use.
    likelihood: str = "bernoulli"
    mix_components: int = 5                    # disc_logistic_mix only
    image_shape: tuple[int, int, int] = (28, 28, 1)
    upsample: str = "nearest"                  # resnet decoder: nearest | conv_transpose
    # gelu | gelu_sigmoid | silu | relu | leaky_relu (models/common.py) —
    # GELU's tanh chain is measured VPU overhead; the TF1-era reference
    # family most plausibly used (Leaky)ReLU (RESULTS.md roofline).
    activation: str = "gelu"
    # group | rms | none (resnet only): rms = channel-only RMSNorm (fuses
    # into neighbors, no spatial stats passes); none = norm-free trunk with
    # 1/sqrt(2) residual scaling — GroupNorm is ~15% of the measured step
    # and the reference's normalization is [I]-level (RESULTS.md roofline).
    norm: str = "group"
    # standard | flow | gaussian: the model's own prior. 'flow' trains a
    # RealNVP prior p_th(z) jointly with the VAE (models/flow_prior.py) —
    # the exact-likelihood counterpart of the adversarial prior (mutually
    # exclusive with adversarial.enabled; enforced in training/step.py).
    # 'gaussian' trains a diagonal N(mu, sigma) base
    # (models/gaussian_prior.py) whose KL gradient moment-matches it to
    # the aggregate posterior — the ex-post diagonal fit learned
    # continuously; unlike 'flow' it COMPOSES with adversarial.enabled:
    # p*(z) ∝ N(mu,sigma)·e^{D(z)} (the base carries q's dispersion, D
    # shapes the residual — the training-time fix for the measured
    # shaped-prior under-dispersion, RESULTS.md 800k A/B).
    prior: str = "standard"
    prior_flow_layers: int = 6                 # prior='flow' only
    prior_flow_hidden: int = 64


@dataclass(frozen=True)
class AdversarialConfig:
    enabled: bool = False
    # 'learned_prior': density-ratio-shaped prior p*(z) ∝ p0(z)·e^{D(z)}
    # 'aae': adversarial posterior-matching regularizer, prior stays N(0,I)
    # 'biadversarial': learned_prior PLUS a second, pixel-space conv
    #   discriminator on decoded reconstructions (the two-discriminator
    #   scheme SURVEY.md §8 item 3 names as a candidate reading of the
    #   reference's objective, per its arXiv 1902.03517 lineage; exact
    #   scheme unverifiable in-env, so this is the config-switchable hedge)
    # (variant is the survey's #1 [I] uncertainty — SURVEY.md §2.4)
    variant: str = "learned_prior"
    weight: float = 1.0                        # λ on the generator's adv term
    # biadversarial only: λ on the generator's pixel-space adversarial term
    # (non-saturating log σ(D_x(x̂))) and the conv D_x's stage widths.
    # D_x shares d_lr, label_smoothing, and n_critic with the latent D.
    pixel_weight: float = 0.05
    pixel_d_widths: tuple[int, ...] = (32, 64, 128)
    # R1 zero-centered gradient penalty γ/2·E_real‖∇D‖² on the D phase
    # (arXiv 1801.04406; 0 = off). The measured CIFAR failure mode is D
    # saturation (d_acc pins at 1.0) — label smoothing is the snapped
    # mitigation; this is the paper-standard alternative/compound knob.
    # Applies to the latent D, and to the pixel D under biadversarial.
    r1_gamma: float = 0.0
    n_critic: int = 1                          # D steps per G step
    # Reuse the G forward's posterior samples for the D phase (G-then-D
    # ordering) — saves one encoder forward per step; False restores the
    # reference's D-first ordering with its own encode (SURVEY.md §3.2).
    d_reuse_posterior: bool = True
    d_lr: float = 1e-4
    # constant | cosine | floor_adaptive: D's learning-rate schedule.
    # 'cosine' decays d_lr to d_lr_end over the run (counted in D
    # optimizer updates, i.e. n_critic per train step) — the open-loop
    # equilibrium knob for the two measured late-run D/G drifts: the
    # fashion counterpart's 30k→60k OOD regression and the CIFAR
    # flagship's D pinning at the smoothing floor from mid-run
    # (RESULTS.md fashion sweep + scaling rows). 'floor_adaptive' is the
    # closed-loop version: each D update is scaled by how far d_loss sits
    # above its analytic smoothing floor (losses.d_loss_floor), so D
    # stops strengthening exactly when it has saturated and re-engages if
    # G catches up.
    d_lr_schedule: str = "constant"
    d_lr_end: float = 1e-5
    d_widths: tuple[int, ...] = (256, 256)
    label_smoothing: float = 0.0
    # Spectral normalization of the latent D's Dense kernels (SN-GAN,
    # arXiv 1802.05957; stateless power-iteration variant — see
    # models/discriminator.py::SNDense). The third D-regularization
    # option next to label_smoothing and r1_gamma.
    d_spectral_norm: bool = False


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 256                      # global (sharded over chips)
    steps: int = 30_000
    lr: float = 1e-3
    lr_warmup_steps: int = 500
    lr_end_value: float = 1e-5                 # cosine decay target
    beta: float = 1.0                          # KL weight
    beta_warmup_steps: int = 0                 # linear KL anneal from 0
    # Free bits (nats per latent dim, 0 = off): the TRAINING objective
    # floors the minibatch-mean per-dim KL at this value before summing
    # (losses.free_bits_kl), removing the pruning pressure on low-KL units.
    # Prior-family-aware: model.prior='gaussian' floors the exact per-dim
    # KL against the trainable base; 'flow' floors the batch-mean TOTAL
    # MC-KL at z_dim·λ (free information — per-dim KL is intractable
    # through the flow). Reported kl/elbo metrics and IWAE eval always
    # use the true KL.
    free_bits: float = 0.0
    # Flow-prior inverse-dispersion penalty (model.prior='flow' only,
    # 0 = off): adds λ·max(0, m_s/m_q − 1)² to the elbo objective, where
    # m_s = E_u~N(0,I)[‖flow⁻¹(u)‖²] (the second moment of the flow's OWN
    # samples at typical base draws) and m_q = stop-grad E_B[‖z_q‖²] (the
    # batch posterior's). One-sided and self-calibrating: penalizes only
    # over-dispersion of the sampler relative to the aggregate posterior.
    # Targets the measured cifar_flow_100k failure (RESULTS.md): MLE is
    # mass-covering, so the trained inverse amplifies TYPICAL base draws
    # into z far outside q's bulk (±500 vs ±150 scatter; Fréchet 10.97)
    # while NLL stays excellent — --temperature (base truncation) was
    # measured-neutral because the expansion lives in the map's bulk, not
    # the base's tails. λ rides the same loss_reduction scale as the KL:
    # with 'sum', λ≈z_dim gives the penalty KL-comparable gradients.
    flow_dispersion_penalty: float = 0.0
    # elbo | iwae: the training objective. 'iwae' trains on the k-sample
    # importance-weighted bound (IWAE paper, arXiv 1509.00519 — the eval
    # estimator's bound used as the objective, with small k): the k samples
    # fold into the decoder batch axis so the MXU sees one [k·B] call.
    # Incompatible with free_bits (no per-dim KL term in the bound).
    objective: str = "elbo"
    iwae_k: int = 5                    # importance samples (objective=iwae)
    # reparam | dreg: inference-net gradient estimator for objective=iwae.
    # 'dreg' (doubly-reparameterized, Tucker et al. 2018) removes the score
    # term and reweights the encoder path by normalized-w² — same bound
    # value, higher-SNR φ gradients (the default for good reason).
    iwae_grad: str = "dreg"
    seed: int = 0
    log_every: int = 100
    checkpoint_every: int = 2_000
    grad_clip_norm: float = 5.0
    # sum | mean_per_dim: how the per-sample objective is reduced into the
    # scalar loss. 'sum' (reference convention) sums log-likelihoods over
    # pixels — raw grad norms are ~1e6 for CIFAR so the global-norm clip is
    # ALWAYS active and training is effectively normalized-gradient descent
    # (TODO.md loss-scale note). 'mean_per_dim' divides the objective by the
    # pixel count: grad norms are O(1), the clip only fires on true spikes,
    # and peak-LR semantics are meaningful for real-data tuning. Adam is
    # scale-invariant, so the ONLY behavioral difference is clip activity.
    # Reported metrics (elbo/recon/kl) stay in nats either way.
    loss_reduction: str = "sum"
    # Accumulate gradients over k micro-steps before each optimizer update
    # (effective batch = k * batch_size without the activation memory).
    # cfg.train.steps still counts micro-steps; LR/β schedules are scaled
    # so the decay profile matches the k=1 run in wall-clock terms.
    grad_accum: int = 1
    # Polyak/EMA parameter averaging (0 = off): eval/sample/export consume
    # the averaged params when on — the EMA point is the better generative
    # model late in training.
    ema_decay: float = 0.0
    # >1: the host dispatches k training steps as ONE jitted lax.scan call
    # over a stacked batch — amortizes per-step dispatch latency for small
    # models whose compute time is shorter than the host round-trip (the
    # MNIST configs; the CIFAR step is compute-bound and doesn't need it).
    # steps / eval_every / checkpoint_every must be multiples of k.
    steps_per_call: int = 1
    eval_every: int = 1_000            # periodic validation (0 = off)
    valid_fraction: float = 0.05       # carved from the train split


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "mnist"
    binarize: bool = True                      # static binarization (MNIST)
    dequantize: bool = False                   # uniform dequantize (CIFAR)
    # Bit-pack binarized payloads 8 pixels/byte for the host→HBM transfer
    # (unpacked on device inside the jitted step). The MNIST loop is
    # transfer-bound (RESULTS.md dispatch table), so this is an 8× cut on
    # the binding axis; lossless (packed ≡ unpacked, tested). Only
    # effective when binarize=True.
    bit_pack: bool = True
    # Keep the ENTIRE training set resident in HBM (uploaded once,
    # replicated per chip) and feed the jitted step int32 index batches
    # instead of pixel rows; rows are gathered on device. Removes the
    # per-step host→HBM payload — the measured bottleneck of the in-loop
    # path on this relay (RESULTS.md dispatch table) — at the cost of one
    # dataset-sized upload + one dataset replica per chip (CIFAR-10 uint8:
    # 153 MB; packed MNIST: 5.9 MB). Data order, PRNG schedule, and resume
    # bookkeeping are bit-identical to the streaming path (the index
    # Batcher draws the same permutations). Multi-host: every process
    # uploads the same full arrays and the replicated global array is
    # assembled via multihost.put_batch — same contract as batches.
    device_resident: bool = False
    data_dir: str | None = None
    synthetic_size: int | None = None          # cap fallback dataset size


@dataclass(frozen=True)
class EvalConfig:
    iwae_k: int = 1_000
    iwae_chunk: int = 50
    batch_size: int = 64
    max_examples: int | None = None            # cap test examples (smoke runs)
    # >1 shards the importance-sample axis over a (data, k) device mesh
    # with a cross-chip logsumexp merge (eval/sharded.py).
    k_shards: int = 1


@dataclass(frozen=True)
class OODConfig:
    in_dataset: str = "cifar10"
    ood_dataset: str = "svhn"
    # 'iwae': per-sample IWAE-k̃ log-likelihood;
    # 'elbo': single-sample ELBO;
    # 'prior_ratio': log p*(x)-style ratio using the adversarial prior's
    #   density-ratio correction vs the base N(0,I) prior — one reading of
    #   the likelihood-*ratio* score motivating config 5 (SURVEY.md §3.5, [I]);
    # 'model_ratio': the other reading — per-sample score under TWO models
    #   (this checkpoint vs the ``baseline_of`` checkpoint, e.g.
    #   adversarial-prior vs plain-prior).
    # 'pixel_d': the biadversarial pixel discriminator's realness logit
    #   D_x(x) — one conv forward per image, no IWAE (biadversarial
    #   checkpoints only).
    # 'complexity': log p(x) + PNG codelength (nats) — the input-
    #   complexity-adjusted likelihood (Serrà et al. 2020), a likelihood
    #   ratio against a universal compressor; works on ANY checkpoint
    #   (no adversarial prior or second model needed).
    score: str = "prior_ratio"
    iwae_k: int = 100
    iwae_chunk: int = 50
    batch_size: int = 64
    max_examples: int | None = 2_000
    # results-dir name (its config.json defines the architecture) of the
    # denominator model for score='model_ratio'.
    baseline_of: str | None = None
    # results-dir name of a model trained on ood_dataset; ``--both`` scores
    # the reversed pair direction with it (falls back to this checkpoint).
    reverse_of: str | None = None


@dataclass(frozen=True)
class Config:
    name: str = "mnist_vae"
    # Eval-only presets (iwae_eval, ood_suite) read checkpoints written by
    # the training preset named here; None -> own results dir.
    checkpoint_of: str | None = None
    model: ModelConfig = field(default_factory=ModelConfig)
    adversarial: AdversarialConfig = field(default_factory=AdversarialConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    ood: OODConfig = field(default_factory=OODConfig)
    results_dir: str = "results"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def config_from_dict(d: dict) -> Config:
    """Rebuild a Config from ``dataclasses.asdict`` output (results-dir
    config.json): nested sections become their dataclasses, JSON lists
    become the tuples the fields declare. Unknown keys are ignored so old
    configs keep loading across field additions."""
    nested = {"model": ModelConfig, "adversarial": AdversarialConfig,
              "train": TrainConfig, "data": DataConfig, "eval": EvalConfig,
              "ood": OODConfig}

    def build(cls, sub: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in sub.items() if k in names}
        return cls(**kw)

    top = {f.name for f in dataclasses.fields(Config)}
    kw = {}
    for k, v in d.items():
        if k in nested:
            kw[k] = build(nested[k], v)
        elif k in top:
            kw[k] = v
    return Config(**kw)


# ---------------------------------------------------------------------------
# The five named presets (BASELINE.json configs 1-5, SURVEY.md §0.1)
# ---------------------------------------------------------------------------

# The MNIST conv-VAE step is ~4 ms of compute behind ~15 ms of per-dispatch
# relay/host latency: 8 steps per lax.scan dispatch takes the measured
# in-loop rate from ~13k to ~54k img/s/chip together with the uint8
# binarized payload (RESULTS.md dispatch probe).
_MNIST_TRAIN = TrainConfig(steps_per_call=8)
# HBM-resident dataset (round 3): the packed train set is 5.9 MB; feeding
# index batches instead of pixel rows measured 223.7k -> 231.4k img/s at
# k=8 (RESULTS.md dispatch table) and strictly shrinks the transfer.
_MNIST_DATA = DataConfig(device_resident=True)


def _mnist_vae() -> Config:
    """Config 1: Conv-VAE on binarized MNIST, standard Gaussian prior."""
    return Config(name="mnist_vae", train=_MNIST_TRAIN, data=_MNIST_DATA)


def _mnist_advprior() -> Config:
    """Config 2: adversarial-prior VAE on MNIST.

    Schedule defaults from the round-2 10k-step sweep (scripts/gan_sweep.py,
    RESULTS.md): label smoothing 0.1 keeps D off its saturation floor —
    d_loss ~1.0 instead of ~1e-3..1e-9 — which is what makes D's density
    ratio usable (prior-ratio OOD AUROC 0.46 → 0.92 on the synthetic
    MNIST↔FashionMNIST pair) and also improves the ELBO; d_lr 4e-4 on top
    was the best variant measured. More critic steps (n_critic 3/5) only
    saturate D harder and score WORSE — the knob stays 1.
    """
    return Config(
        name="mnist_advprior",
        train=_MNIST_TRAIN,
        data=_MNIST_DATA,
        adversarial=AdversarialConfig(enabled=True, label_smoothing=0.1,
                                      d_lr=4e-4),
    )


def _cifar_advprior_resnet() -> Config:
    """Config 3: CIFAR-10 ResNet VAE, adversarial prior, disc-logistic."""
    return Config(
        name="cifar_advprior_resnet",
        # conv_transpose decoder: +6.6% train throughput vs nearest-upsample
        # (15.3 vs 16.3 ms/step measured on v5e; kernel 4 % stride 2 == 0
        # avoids checkerboard)
        # norm=rms: measured faster than GroupNorm (14.69 vs 15.34 ms/step)
        # AND better bits/dim at the 3k and 10k gates (2.582 vs 2.913,
        # 1.391 vs 1.72 — RESULTS.md roofline §2b), so the flagship
        # defaults to it on both axes.
        # activation=silu (round 3): quality-gated at the same protocol —
        # 3k/k=100 2.495 vs gelu 2.582, 10k/k=1000 1.315 vs 1.391 — and
        # ~1 ms/step cheaper than GELU's tanh chain (RESULTS.md roofline
        # §3), so the flagship snaps to it on both axes too.
        model=ModelConfig(family="resnet", z_dim=128, widths=(64, 128, 256),
                          likelihood="discretized_logistic",
                          image_shape=(32, 32, 3), upsample="conv_transpose",
                          norm="rms", activation="silu"),
        # label smoothing keeps D off the saturation plateau observed in
        # full-scale runs (d_loss -> 5e-4 by step 2500 without it)
        adversarial=AdversarialConfig(enabled=True, label_smoothing=0.1),
        # device_resident + steps_per_call=8 (round 3): with the dataset in
        # HBM the old CIFAR multi-step objection (3 MB host-stacked
        # payloads) vanishes — index stacks are 4 B/image. Measured
        # in-loop: streaming k=1 26.6 ms/step -> resident k=1 17.1 ->
        # resident k=8 13.8 ms/step (18.5k img/s, the compute ceiling;
        # RESULTS.md dispatch table). CIFAR-10 uint8 resident: 153 MB/chip.
        train=TrainConfig(batch_size=256, steps=100_000, lr=5e-4,
                          beta_warmup_steps=5_000, steps_per_call=8),
        data=DataConfig(dataset="cifar10", binarize=False, dequantize=True,
                        device_resident=True),
    )


def _iwae_eval() -> Config:
    """Config 4: IWAE-k evaluation pipeline, k=1000, bits/dim reporting."""
    cfg = _cifar_advprior_resnet()
    # iwae_chunk=25: measured fastest k=1000 scan chunk for the flagship
    # decoder (114 img/s vs 87 at 50, 73-99 at 8/10/20/40 — reproduced
    # best-of-3-window runs, scripts/iwae_chunk_probe.py). Chunk size is
    # math-invariant (tests/test_iwae.py chunk-invariance).
    return dataclasses.replace(cfg, name="iwae_eval",
                               checkpoint_of="cifar_advprior_resnet",
                               eval=EvalConfig(iwae_k=1_000, iwae_chunk=25))


def _ood_suite() -> Config:
    """Config 5: sampling + OOD scoring (MNIST↔FashionMNIST, CIFAR↔SVHN)."""
    cfg = _cifar_advprior_resnet()
    return dataclasses.replace(cfg, name="ood_suite",
                               checkpoint_of="cifar_advprior_resnet",
                               ood=OODConfig())


# ---------------------------------------------------------------------------
# Measured-best presets (beyond the reference surface — round-4/5 gates).
# The five [B]-faithful presets above stay the defaults; these two make the
# measured winners reachable without mining RESULTS.md for --set
# incantations (round-4 verdict weak-6).
# ---------------------------------------------------------------------------


def _cifar_gb() -> Config:
    """Measured-best GENERATION config (round-4 trainable-base gate):
    the flagship with model.prior='gaussian' — a trainable diagonal base
    composed with the adversarial D, p*(z) ∝ N(μ,σ)·e^{D(z)}. At 100k
    the shaped-prior Fréchet drops 4.356 → 0.365 (12×, beating even its
    own ex-post fit) at bits/dim parity with the standard-base flagship
    (RESULTS.md trainable-base gate). Beyond the [B] surface; the
    [B]-faithful default remains cifar_advprior_resnet."""
    cfg = _cifar_advprior_resnet()
    return dataclasses.replace(
        cfg, name="cifar_gb",
        model=dataclasses.replace(cfg.model, prior="gaussian"))


def _cifar_flow() -> Config:
    """Measured-best NLL config (round-4 flow-prior gate): the flagship
    with a jointly-trained RealNVP prior instead of the adversarial game
    — exact density, exact log Z = 0. At 100k steps: 0.7041 bits/dim
    EXACT, beating the 800k adversarial run (0.7283) at 1/8 the steps
    (RESULTS.md flow-prior section). Generation needs
    train.flow_dispersion_penalty or --prior expost_* (the raw inverse
    over-disperses — measured). Beyond the [B] surface."""
    cfg = _cifar_advprior_resnet()
    return dataclasses.replace(
        cfg, name="cifar_flow",
        model=dataclasses.replace(cfg.model, prior="flow"),
        adversarial=AdversarialConfig(enabled=False))


PRESETS = {
    "mnist_vae": _mnist_vae,
    "mnist_advprior": _mnist_advprior,
    "cifar_advprior_resnet": _cifar_advprior_resnet,
    "iwae_eval": _iwae_eval,
    "ood_suite": _ood_suite,
    "cifar_gb": _cifar_gb,
    "cifar_flow": _cifar_flow,
}


def get_preset(name: str) -> Config:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()


# ---------------------------------------------------------------------------
# Dot-path CLI overrides
# ---------------------------------------------------------------------------

def _parse_value(existing: Any, raw: str) -> Any:
    if isinstance(existing, bool):
        if raw.lower() in ("1", "true", "yes"):
            return True
        if raw.lower() in ("0", "false", "no"):
            return False
        raise ValueError(f"bad bool {raw!r}")
    if isinstance(existing, int) and not isinstance(existing, bool):
        return int(raw)
    if isinstance(existing, float):
        return float(raw)
    if isinstance(existing, tuple):
        return tuple(json.loads(raw))
    if existing is None:
        # Untyped slot: try JSON, fall back to string.
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            return raw
    return raw


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply ``path.to.field=value`` strings to a frozen config tree."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form path=value")
        path, raw = item.split("=", 1)
        keys = path.split(".")
        cfg = _replace_path(cfg, keys, raw)
    return cfg


def _replace_path(node, keys: list[str], raw: str):
    head, rest = keys[0], keys[1:]
    if not hasattr(node, head):
        raise ValueError(
            f"no config field {head!r} on {type(node).__name__}; "
            f"have {[f.name for f in dataclasses.fields(node)]}")
    cur = getattr(node, head)
    new = _replace_path(cur, rest, raw) if rest else _parse_value(cur, raw)
    return dataclasses.replace(node, **{head: new})
