"""Device dispatch for the scoring path's fused ops (counterpart of
``apv_tpu/ops/dispatch.py``).

A CPU tensor goes to the op's plain PyTorch version; a CUDA tensor goes to
its hand-written kernel, which launches or raises. There is no switch and
no fallback that sends CUDA tensors to the plain versions.

All ops take tensors whose axis 0 is the batch axis; the likelihood and
divergence ops reduce every other axis to one value per sample.
"""

from __future__ import annotations

import torch

from apv_tpu_torch.ops import kernels as K


def _on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"{name}: inputs must all be on the CPU or all on one "
                     f"CUDA device, got {sorted(kinds)}")


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).contiguous()


def reparam_sample(mean: torch.Tensor, logvar: torch.Tensor,
                   samples: int | None = None, *,
                   generator: torch.Generator | None = None,
                   eps: torch.Tensor | None = None) -> torch.Tensor:
    """z = mean + exp(logvar/2)·eps, eps ~ N(0, I).

    ``samples=None`` draws one z of mean's shape; ``samples=S`` draws
    [S, *mean.shape]. The noise comes from ``generator`` (a CPU
    ``torch.Generator``) through the kernel's Philox stream, on either
    device. ``eps`` injects the noise instead and is accepted only for CPU
    tensors (the parity tests hand in JAX's draws), so the card's path can
    never skip its kernel.
    """
    s = 1 if samples is None else samples
    if _on_cpu("reparam_sample", mean, logvar):
        if eps is not None:
            want = tuple(mean.shape) if samples is None else (
                (samples,) + tuple(mean.shape))
            if tuple(eps.shape) != want:
                raise ValueError(f"reparam_sample: eps has shape "
                                 f"{tuple(eps.shape)}, expected {want}")
            return K.reparam_from_eps(mean, logvar, eps)
        z = K.reparam_plain(mean, logvar, s, *K.draw_key(generator))
    else:
        if eps is not None:
            raise ValueError("reparam_sample: eps is accepted only for CPU "
                             "tensors; on CUDA the kernel draws the noise")
        z = K.reparam_cuda(mean.contiguous(), logvar.contiguous(), s,
                           *K.draw_key(generator))
    return z if samples is not None else z[0]


def kl_standard(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Per-sample KL(q || N(0, I)), summed over event dims -> [B]."""
    if _on_cpu("kl_standard", mean, logvar):
        return K.kl_plain(mean, logvar)
    return K.kl_cuda(_rows(mean), _rows(logvar))


def disc_logistic_recon_ll(x: torch.Tensor, mean: torch.Tensor,
                           log_scale: torch.Tensor, *,
                           bin_size: float = 1.0 / 255.0) -> torch.Tensor:
    """Per-sample discretized-logistic log-likelihood -> [B]."""
    if _on_cpu("disc_logistic_recon_ll", x, mean, log_scale):
        return K.disc_logistic_plain(x, mean, log_scale, bin_size)
    return K.disc_logistic_cuda(_rows(x), _rows(mean), _rows(log_scale),
                                bin_size)
