"""The scorer's forward kernels as ``torch.library`` custom ops, for the
serving artifacts (``serving.export_scorer``).

``torch.export`` cannot trace a ctypes launch, but it keeps a custom op as
one node of the exported graph. Each op here is one of the four forward
kernels on the scorer's path: ``apv::reparam``, ``apv::kl``,
``apv::bernoulli`` and ``apv::disc_logistic`` (the ``*_rows`` forms, with
x at B rows beside parameters at ``samples``·B), and ``apv::rmsnorm_act``,
which ``ops.rmsnorm_act`` calls while it is traced, so the ResNet's norms
are one node each in the scorer's and the sampler's graphs. Their CUDA
implementations call the kernels' wrappers in ``ops/kernels.py``, which
launch the hand-written kernel on the caller's current stream and count
the launch in ``K.launches``, so an artifact traced on the card runs the
kernels, and a launch that fails fails the call. Their CPU
implementations are the plain versions; their fake implementations give
the output's shape from the inputs', so the row count stays symbolic.

``apv::reparam`` takes its Philox key (seed, offset) as an int64 CPU
tensor, read on the host without a device sync; a key on the card is
refused.

Training does not use these ops: its differentiable path is
``ops/dispatch.py``'s ``autograd.Function``s.
"""

from __future__ import annotations

import torch

from apv_tpu_torch.ops import kernels as K
from apv_tpu_torch.ops.dispatch import _check_samples

Tensor = torch.Tensor


def _rows(t: Tensor) -> Tensor:
    return t.reshape(t.shape[0], -1).to(torch.float32).contiguous()


def _host_key(key: Tensor) -> tuple[int, int]:
    if key.device.type != "cpu" or key.dtype != torch.int64 \
            or tuple(key.shape) != (2,):
        raise ValueError("apv::reparam: the Philox key is an int64 CPU "
                         f"tensor of shape (2,), got {key.dtype} "
                         f"{tuple(key.shape)} on {key.device}")
    seed, offset = key.tolist()
    return seed, offset


# ---------------------------------------------------------------------------
# reparam: [samples, *mean.shape] draws of mean + e^{logvar/2}·ε
# ---------------------------------------------------------------------------

@torch.library.custom_op("apv::reparam", mutates_args=(),
                         device_types="cpu")
def reparam(mean: Tensor, logvar: Tensor, samples: int,
            key: Tensor) -> Tensor:
    return K.reparam_plain(mean.to(torch.float32), logvar.to(torch.float32),
                           samples, *_host_key(key))


@reparam.register_kernel("cuda")
def _reparam_cuda(mean, logvar, samples, key):
    return K.reparam_cuda(mean.to(torch.float32).contiguous(),
                          logvar.to(torch.float32).contiguous(), samples,
                          *_host_key(key))


@reparam.register_fake
def _reparam_fake(mean, logvar, samples, key):
    return mean.new_empty((samples,) + tuple(mean.shape),
                          dtype=torch.float32)


# ---------------------------------------------------------------------------
# kl: per-row KL(q || N(0, I))
# ---------------------------------------------------------------------------

@torch.library.custom_op("apv::kl", mutates_args=(), device_types="cpu")
def kl(mean: Tensor, logvar: Tensor) -> Tensor:
    return K.kl_plain(_rows(mean), _rows(logvar))


@kl.register_kernel("cuda")
def _kl_cuda(mean, logvar):
    return K.kl_cuda(_rows(mean), _rows(logvar))


@kl.register_fake
def _kl_fake(mean, logvar):
    return mean.new_empty((mean.shape[0],), dtype=torch.float32)


# ---------------------------------------------------------------------------
# the likelihoods: x [B, ...] beside parameters [samples·B, ...] -> [rows]
# ---------------------------------------------------------------------------

@torch.library.custom_op("apv::bernoulli", mutates_args=(),
                         device_types="cpu")
def bernoulli(x: Tensor, logits: Tensor, samples: int) -> Tensor:
    _check_samples("apv::bernoulli", x, logits, samples)
    return K.bernoulli_plain(_rows(x), _rows(logits))


@bernoulli.register_kernel("cuda")
def _bernoulli_cuda(x, logits, samples):
    _check_samples("apv::bernoulli", x, logits, samples)
    return K.bernoulli_cuda(_rows(x), _rows(logits))


@bernoulli.register_fake
def _bernoulli_fake(x, logits, samples):
    _check_samples("apv::bernoulli", x, logits, samples)
    return logits.new_empty((logits.shape[0],), dtype=torch.float32)


@torch.library.custom_op("apv::disc_logistic", mutates_args=(),
                         device_types="cpu")
def disc_logistic(x: Tensor, mean: Tensor, log_scale: Tensor,
                  bin_size: float, samples: int) -> Tensor:
    _check_samples("apv::disc_logistic", x, mean, samples)
    return K.disc_logistic_plain(_rows(x), _rows(mean), _rows(log_scale),
                                 bin_size)


@disc_logistic.register_kernel("cuda")
def _disc_logistic_cuda(x, mean, log_scale, bin_size, samples):
    _check_samples("apv::disc_logistic", x, mean, samples)
    return K.disc_logistic_cuda(_rows(x), _rows(mean), _rows(log_scale),
                                bin_size)


@disc_logistic.register_fake
def _disc_logistic_fake(x, mean, log_scale, bin_size, samples):
    _check_samples("apv::disc_logistic", x, mean, samples)
    return mean.new_empty((mean.shape[0],), dtype=torch.float32)


# ---------------------------------------------------------------------------
# rmsnorm_act: the ResNet's RMSNorm and activation over x's last axis
# ---------------------------------------------------------------------------

@torch.library.custom_op("apv::rmsnorm_act", mutates_args=(),
                         device_types="cpu")
def rmsnorm_act(x: Tensor, weight: Tensor, activation: str,
                eps: float) -> Tensor:
    return K.rmsnorm_act_plain(x, weight, activation, eps)


@rmsnorm_act.register_kernel("cuda")
def _rmsnorm_act_cuda(x, weight, activation, eps):
    return K.rmsnorm_act_cuda(x.contiguous(),
                              weight.to(torch.float32).contiguous(),
                              activation, eps)[0]


@rmsnorm_act.register_fake
def _rmsnorm_act_fake(x, weight, activation, eps):
    K.activation_id(activation)
    return x.new_empty(x.shape)


OPS = ("reparam", "kl", "bernoulli", "disc_logistic", "rmsnorm_act")
