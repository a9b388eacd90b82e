"""The fused ops: CUDA kernels (forward and backward) on the card, plain
PyTorch on the CPU (``ops/dispatch.py``)."""

from apv_tpu_torch.ops.dispatch import (bernoulli_recon_ll,
                                        disc_logistic_recon_ll, kl_standard,
                                        reparam_sample)

__all__ = ["bernoulli_recon_ll", "disc_logistic_recon_ll", "kl_standard",
           "reparam_sample"]
