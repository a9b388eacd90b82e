"""apv_tpu_torch — the PyTorch/CUDA port of apv_tpu for NVIDIA Hopper.

This slice runs the scoring path: the per-sample ELBO scorer and IWAE-k
evaluation to bits/dim of the CIFAR-10 ResNet VAE with its adversarial
latent prior. The reparameterized sampling, KL and discretized-logistic
likelihood run in hand-written CUDA kernels on the card
(``apv_tpu_torch.ops``) and in plain PyTorch on the CPU.

Entry points take ``device=None``, meaning the CUDA card; they raise when
there is none. Pass ``device="cpu"`` for the plain path.
"""

from apv_tpu_torch.eval.run import evaluate_nll
from apv_tpu_torch.models import build_model, make_latent_d
from apv_tpu_torch.serving import make_scorer
from apv_tpu_torch.utils.config import apply_overrides, get_preset

__all__ = ["apply_overrides", "build_model", "evaluate_nll", "get_preset",
           "make_latent_d", "make_scorer"]
