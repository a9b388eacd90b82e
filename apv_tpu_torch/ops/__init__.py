"""The scoring path's fused ops: CUDA kernels on the card, plain PyTorch on
the CPU (``ops/dispatch.py``)."""

from apv_tpu_torch.ops.dispatch import (disc_logistic_recon_ll, kl_standard,
                                        reparam_sample)

__all__ = ["disc_logistic_recon_ll", "kl_standard", "reparam_sample"]
