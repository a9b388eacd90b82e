"""apv_tpu_torch — the PyTorch/CUDA port of apv_tpu for NVIDIA Hopper.

Ported so far: the scoring path (per-sample ELBO scorer and IWAE-k to
bits/dim) of the CIFAR-10 ResNet VAE and of the MNIST conv VAE, and
training on one card of the MNIST configs and of the CIFAR-10 flagship
(``cifar_advprior_resnet``: on-device dequantization, the dataset loaders
with their synthetic fallback, validation, checkpoints and exact resume),
and config 5 on a trained checkpoint: SIR/MALA and ex-post sampling with
sample-quality distances (``sample``) and OOD scoring (``ood_score``).
The front door is ``train``, ``evaluate`` (config 4, under the model's
prior or an ex-post prior, with the active units of
``posterior_activity``), ``sample``, ``visualize`` (reconstruction and
interpolation grids, the latent scatter), ``ood_score``,
``export_artifact`` (``torch.export`` serving artifacts of the sampler
and the scorer, int8 weights optional) and ``info``, and the
``apv-torch`` CLI (``python -m apv_tpu_torch.cli``). Checkpoints of the
reference (orbax) restore and resume alongside the port's own
(``import_orbax`` writes them in the port's format). The
discriminators include the spectrally normalized latent D, the R1 penalty
and the biadversarial pixel D with its ``pixel_d`` OOD score. The training
knobs include the cosine and floor-adaptive D learning rates, gradient
accumulation and the EMA shadow that the eval-side entry points read;
the likelihoods include the mixture of discretized logistics. Training
and evaluation also run data-parallel over ``torch.distributed``, one
process a card (``apv-torch train --distributed``; ``parallel/``), with
the k-sharded IWAE (``eval/sharded.py``).
Reparameterized sampling, KL and the Bernoulli and discretized-logistic
likelihoods run in hand-written CUDA kernels on the card
(``apv_tpu_torch.ops``), each with a backward kernel, and in plain
PyTorch on the CPU; so do the fused GroupNorm + GELU op
(``groupnorm_gelu``) and the conv probe's 3×3 conv kernel
(``python -m apv_tpu_torch.ops.conv_probe``).

Entry points take ``device=None``, meaning the CUDA card; they raise when
there is none. Pass ``device="cpu"`` for the plain path.
"""

from apv_tpu_torch.api import (evaluate, export_artifact, info, ood_score,
                               sample, train, visualize)
from apv_tpu_torch.data.datasets import load_dataset
from apv_tpu_torch.eval.ood import ood_both, ood_scores
from apv_tpu_torch.eval.run import evaluate_nll, posterior_activity
from apv_tpu_torch.eval.sample_quality import sample_quality
from apv_tpu_torch.models import build_model, make_latent_d
from apv_tpu_torch.ops.groupnorm import groupnorm_gelu
from apv_tpu_torch.sampling.run import generate_samples
from apv_tpu_torch.serving import (export_sampler, export_scorer,
                                   load_exported, make_sampler, make_scorer)
from apv_tpu_torch.training.loop import train_loop
from apv_tpu_torch.training.step import make_train_fns
from apv_tpu_torch.utils.checkpoint import (import_orbax, latest_step,
                                           restore_checkpoint,
                                           save_checkpoint)
from apv_tpu_torch.utils.config import apply_overrides, get_preset

__all__ = ["apply_overrides", "build_model", "evaluate", "evaluate_nll",
           "export_artifact", "export_sampler", "export_scorer",
           "generate_samples", "get_preset", "groupnorm_gelu",
           "import_orbax", "info", "latest_step", "load_dataset",
           "load_exported", "make_latent_d", "make_sampler",
           "make_scorer", "make_train_fns", "ood_both", "ood_score",
           "ood_scores", "posterior_activity", "restore_checkpoint",
           "sample", "sample_quality", "save_checkpoint", "train",
           "train_loop", "visualize"]
