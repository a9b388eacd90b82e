"""The fused ops: CUDA kernels (forward and backward) on the card, plain
PyTorch on the CPU (``ops/dispatch.py``, ``ops/groupnorm.py``). The conv
probe's kernel lives in ``ops/conv_probe.py``."""

from apv_tpu_torch.ops.dispatch import (bernoulli_recon_ll,
                                        disc_logistic_recon_ll, kl_standard,
                                        reparam_sample)
from apv_tpu_torch.ops.groupnorm import groupnorm_gelu

__all__ = ["bernoulli_recon_ll", "disc_logistic_recon_ll", "groupnorm_gelu",
           "kl_standard", "reparam_sample"]
