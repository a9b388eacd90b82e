"""Fused GroupNorm + tanh-GELU (counterpart of ``apv_tpu/ops/groupnorm.py``).

``groupnorm_gelu(x, gamma, beta, groups, eps)`` is
``GELU_tanh(GroupNorm(x)·gamma + beta)`` with float32 statistics, for NHWC
x with C % groups == 0, as flax's ``GroupNorm(num_groups)`` followed by
``nn.gelu``. Like the reference, it is an op and no model uses it: the
ResNet's ``norm=group`` blocks compute GroupNorm and GELU unfused, as the
JAX package does.

On the CPU it is the plain version (the reference's ``_reference``), which
autograd differentiates. On CUDA it is a ``torch.autograd.Function``: the
forward kernel writes y and the per-(row, group) mean and rstd, and the
backward kernel computes the reference's hand-derived rule ``_bwd`` from
them (``ops/csrc/groupnorm_gelu.cu``).
"""

from __future__ import annotations

import torch

from apv_tpu_torch.ops import kernels as K
from apv_tpu_torch.ops.dispatch import _on_cpu


class _GroupNormGeluFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps):
        x = x.detach().contiguous()
        g32 = gamma.detach().to(torch.float32).contiguous()
        b32 = beta.detach().to(torch.float32).contiguous()
        y, mean, rstd = K.groupnorm_gelu_cuda(x, g32, b32, groups, eps)
        ctx.save_for_backward(x, g32, b32, mean, rstd)
        ctx.groups = groups
        ctx.param_dtypes = (gamma.dtype, beta.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g32, b32, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = K.groupnorm_gelu_bwd_cuda(
            dy.to(x.dtype).contiguous(), x, g32, b32, mean, rstd, ctx.groups)
        return (dx, dgamma.to(ctx.param_dtypes[0]),
                dbeta.to(ctx.param_dtypes[1]), None, None)


def groupnorm_gelu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   groups: int = 8, eps: float = 1e-6) -> torch.Tensor:
    """y = GELU_tanh(GroupNorm(x)·gamma + beta) for NHWC x [B, H, W, C]
    (float32 or bfloat16; y in x's dtype), differentiable in x, gamma and
    beta. Raises ``ValueError`` unless C % groups == 0.

    The port's ResNet keeps activations in NCHW channels_last; such a
    tensor's ``x.permute(0, 2, 3, 1)`` is a contiguous NHWC view of the same
    memory (no copy), which is what this op takes; permute the result back
    with ``y.permute(0, 3, 1, 2)``.
    """
    if _on_cpu("groupnorm_gelu", x, gamma, beta):
        return K.groupnorm_gelu_plain(x, gamma, beta, groups, eps)[0]
    K._group_shape(x, groups)            # the ValueError before any launch
    return _GroupNormGeluFn.apply(x, gamma, beta, int(groups), float(eps))
