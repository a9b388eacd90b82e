"""The fused ops: CUDA kernels (forward and backward) on the card, plain
PyTorch on the CPU (``ops/dispatch.py``, ``ops/groupnorm.py``,
``ops/rmsnorm.py``). The conv probe's kernel lives in
``ops/conv_probe.py``. The logistic mixture's likelihood is plain PyTorch
on both."""

from apv_tpu_torch.ops.dispatch import (bernoulli_recon_ll,
                                        disc_logistic_mix_recon_ll,
                                        disc_logistic_recon_ll, kl_standard,
                                        reparam_kl, reparam_prior_kl,
                                        reparam_sample)
from apv_tpu_torch.ops.groupnorm import groupnorm_gelu
from apv_tpu_torch.ops.rmsnorm import rmsnorm_act

__all__ = ["bernoulli_recon_ll", "disc_logistic_mix_recon_ll",
           "disc_logistic_recon_ll", "groupnorm_gelu", "kl_standard",
           "reparam_kl", "reparam_prior_kl", "reparam_sample",
           "rmsnorm_act"]
