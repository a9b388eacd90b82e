"""apv_tpu_torch — the PyTorch/CUDA port of apv_tpu for NVIDIA Hopper.

Ported so far: the scoring path (per-sample ELBO scorer and IWAE-k to
bits/dim) of the CIFAR-10 ResNet VAE and of the MNIST conv VAE, and the
training step and single-card loop of the MNIST configs (conv VAE,
Bernoulli likelihood, adversarial latent prior). Reparameterized sampling,
KL and the Bernoulli and discretized-logistic likelihoods run in
hand-written CUDA kernels on the card (``apv_tpu_torch.ops``), with
backward kernels for the first three, and in plain PyTorch on the CPU.

Entry points take ``device=None``, meaning the CUDA card; they raise when
there is none. Pass ``device="cpu"`` for the plain path.
"""

from apv_tpu_torch.eval.run import evaluate_nll
from apv_tpu_torch.models import build_model, make_latent_d
from apv_tpu_torch.serving import make_scorer
from apv_tpu_torch.training.loop import train_loop
from apv_tpu_torch.training.step import make_train_fns
from apv_tpu_torch.utils.config import apply_overrides, get_preset

__all__ = ["apply_overrides", "build_model", "evaluate_nll", "get_preset",
           "make_latent_d", "make_scorer", "make_train_fns", "train_loop"]
