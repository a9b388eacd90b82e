"""apv_tpu_torch — the PyTorch/CUDA port of apv_tpu for NVIDIA Hopper.

Ported so far: the scoring path (per-sample ELBO scorer and IWAE-k to
bits/dim) of the CIFAR-10 ResNet VAE and of the MNIST conv VAE, and
training on one card of the MNIST configs and of the CIFAR-10 flagship
(``cifar_advprior_resnet``: on-device dequantization, the dataset loaders
with their synthetic fallback, validation, checkpoints and exact resume).
Reparameterized sampling, KL and the Bernoulli and discretized-logistic
likelihoods run in hand-written CUDA kernels on the card
(``apv_tpu_torch.ops``), each with a backward kernel, and in plain
PyTorch on the CPU.

Entry points take ``device=None``, meaning the CUDA card; they raise when
there is none. Pass ``device="cpu"`` for the plain path.
"""

from apv_tpu_torch.data.datasets import load_dataset
from apv_tpu_torch.eval.run import evaluate_nll
from apv_tpu_torch.models import build_model, make_latent_d
from apv_tpu_torch.serving import make_scorer
from apv_tpu_torch.training.loop import train_loop
from apv_tpu_torch.training.step import make_train_fns
from apv_tpu_torch.utils.checkpoint import (latest_step, restore_checkpoint,
                                           save_checkpoint)
from apv_tpu_torch.utils.config import apply_overrides, get_preset

__all__ = ["apply_overrides", "build_model", "evaluate_nll", "get_preset",
           "latest_step", "load_dataset", "make_latent_d", "make_scorer",
           "make_train_fns", "restore_checkpoint", "save_checkpoint",
           "train_loop"]
