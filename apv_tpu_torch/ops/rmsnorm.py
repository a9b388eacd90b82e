"""RMSNorm followed by the activation, as one op: the ResNet's ``norm=rms``
blocks (``models/common.py::RMSNormAct``).

``rmsnorm_act(x, weight, activation, eps)`` is ``act(n)`` with ``n =
x32·(rsqrt(mean(x32²) + eps)·weight)`` rounded to x's dtype, over x's last
axis, as flax's ``nn.RMSNorm`` followed by the activation. The reference
has no kernel for it: XLA fuses the chain into its neighbours.

On the CPU it is the plain chain (``K.rmsnorm_act_plain``), which autograd
differentiates. On CUDA the forward kernel writes y (and, where autograd
will need it, the per-row rstd) and a ``torch.autograd.Function`` pairs it
with the backward kernel (``ops/csrc/rmsnorm_act.cu``); there is no route
from a CUDA tensor to the plain chain. Under ``torch.export`` (the serving
artifacts) it is the custom op ``apv::rmsnorm_act`` (``ops/export_ops.py``),
one node of the graph on either device.
"""

from __future__ import annotations

import torch

from apv_tpu_torch.ops import kernels as K
from apv_tpu_torch.ops.dispatch import _on_cpu
from apv_tpu_torch.utils.logging import _traced


class _RMSNormActFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, activation, eps):
        x = x.detach()
        w32 = weight.detach().to(torch.float32).contiguous()
        y, rstd = K.rmsnorm_act_cuda(x, w32, activation, eps, want_rstd=True)
        ctx.save_for_backward(x, w32, rstd)
        ctx.activation, ctx.w_dtype = activation, weight.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w32, rstd = ctx.saved_tensors
        dx, dw = K.rmsnorm_act_bwd_cuda(dy.to(x.dtype).contiguous(), x, w32,
                                        rstd, ctx.activation)
        return dx, dw.to(ctx.w_dtype), None, None


def rmsnorm_act(x: torch.Tensor, weight: torch.Tensor, activation: str,
                eps: float = 1e-6) -> torch.Tensor:
    """act(RMSNorm(x)·weight) over the last axis of x [..., C] (float32 or
    bfloat16; y in x's dtype), differentiable in x and weight; the
    activation by its configuration name (``K.ACTIVATIONS``).

    The port's ResNet keeps activations in NCHW channels_last; such a
    tensor's ``x.permute(0, 2, 3, 1)`` is a contiguous NHWC view of the same
    memory (no copy), which is what the kernels take.
    """
    if _traced():
        from apv_tpu_torch.ops import export_ops  # noqa: F401  the op
        return torch.ops.apv.rmsnorm_act(x.contiguous(), weight, activation,
                                         float(eps))
    if _on_cpu("rmsnorm_act", x, weight):
        return K.rmsnorm_act_plain(x, weight, activation, eps)
    K.activation_id(activation)          # the ValueError before any launch
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNormActFn.apply(x, weight, activation, float(eps))
    return K.rmsnorm_act_cuda(x.detach(),
                              weight.detach().to(torch.float32).contiguous(),
                              activation, eps)[0]
