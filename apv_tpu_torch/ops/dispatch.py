"""Device dispatch for the fused ops (counterpart of
``apv_tpu/ops/dispatch.py``).

A CPU tensor goes to the op's plain PyTorch version, which autograd
differentiates. A CUDA tensor goes to a ``torch.autograd.Function`` whose
forward launches the op's hand-written kernel and whose backward launches
its backward kernel: the counterpart of the reference's ``custom_vjp``.
There is no switch and no fallback that sends CUDA tensors to the plain
versions. ``reparam_kl`` serves the ELBO, which draws z from a posterior
and takes its KL: on CUDA both come from one launch and go back through
one.

All ops take tensors whose axis 0 is the batch axis; the likelihood and
divergence ops reduce every other axis to one value per sample. The
likelihood ops also take x with B rows beside parameters with S·B rows
(one image scored under S samples) where the caller names S
(``samples=S``): the kernels read each image once.

The mixture of discretized logistics (``disc_logistic_mix_recon_ll``) is
plain PyTorch on every device: the reference runs it as jnp on every
backend, so it has no TPU kernel to port.
"""

from __future__ import annotations

import torch

from apv_tpu_torch.core import distributions as D
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


# ---------------------------------------------------------------------------
# the CUDA path: forward kernel + backward kernel per op
# ---------------------------------------------------------------------------
# Inside Function.forward the inputs still carry requires_grad, and so do
# the saved tensors in backward; the raw wrappers refuse those, so both
# hand them detached.

class _ReparamFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mean, logvar, samples, seed, offset):
        mean, logvar = mean.detach(), logvar.detach()
        z = K.reparam_cuda(mean, logvar, samples, seed, offset)
        ctx.save_for_backward(z, mean)
        return z

    @staticmethod
    def backward(ctx, g):
        z, mean = ctx.saved_tensors      # z, an output, comes back with grad
        dmean, dlogvar = K.reparam_bwd_cuda(g.contiguous(), z.detach(), mean)
        return dmean, dlogvar, None, None, None


class _PosteriorFn(torch.autograd.Function):
    """z [S, *mean.shape] and the per-row KL(q || N(0, I)) of one
    posterior: the reparam kernel's launch with its KL blocks, and one
    launch of its backward for both (the KL's terms joined to z's). An
    output that gets no gradient hands the backward None (no zeros are
    made for it): a KL that the loss does not use adds no term."""

    @staticmethod
    def forward(ctx, mean, logvar, samples, seed, offset):
        mean, logvar = mean.detach(), logvar.detach()
        z, kl = K.reparam_kl_cuda(mean, logvar, samples, seed, offset)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(z, mean, logvar)
        return z, kl

    @staticmethod
    def backward(ctx, g, g_kl):
        if g is None and g_kl is None:
            return None, None, None, None, None
        z, mean, logvar = ctx.saved_tensors
        dmean, dlogvar = K.reparam_bwd_cuda(
            None if g is None else g.contiguous(), z.detach(), mean,
            g_kl=None if g_kl is None else g_kl.contiguous(), logvar=logvar)
        return dmean, dlogvar, None, None, None


class _PriorPosteriorFn(torch.autograd.Function):
    """z and the per-image KL to a learned prior of one VDVAE layer, from
    the branches' outputs q and p read in place: the reparam kernel's
    learned-prior launch, and one launch of its backward for the gradients
    of q and p (None where an output gets no gradient)."""

    @staticmethod
    def forward(ctx, q, p, seed, offset):
        q, p = q.detach(), p.detach()
        z, kl = K.reparam_prior_cuda(q, p, seed, offset)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(z, q, p)
        return z, kl

    @staticmethod
    def backward(ctx, g, g_kl):
        if g is None and g_kl is None:
            return None, None, None, None
        z, q, p = ctx.saved_tensors
        dq, dp = K.reparam_prior_bwd_cuda(
            None if g is None else g.contiguous(
                memory_format=torch.channels_last),
            z.detach(), q, p, None if g_kl is None else g_kl.contiguous())
        return dq, dp, None, None


class _KLFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mean, logvar):
        mean, logvar = mean.detach(), logvar.detach()
        ctx.save_for_backward(mean, logvar)
        return K.kl_cuda(mean, logvar)

    @staticmethod
    def backward(ctx, g):
        mean, logvar = ctx.saved_tensors
        return K.kl_bwd_cuda(g.contiguous(), mean, logvar)


def _check_samples(name: str, x: torch.Tensor, params: torch.Tensor,
                   samples: int) -> None:
    """The parameters hold ``samples`` rows for each of x's B rows: B·S
    of them. S = 1, the default, asks for x at the parameters' rows."""
    if (samples < 1 or x.dim() == 0 or params.dim() == 0
            or params.shape[0] != samples * x.shape[0]):
        raise ValueError(f"{name}: x {tuple(x.shape)} does not pair with "
                         f"parameters {tuple(params.shape)} at samples="
                         f"{samples}: they need samples × x's rows")


def _x_grad(dx: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor | None:
    """dx at the parameters' [S·B, E] -> x's [B, E]: the sum over the S
    samples, the adjoint of the forward's broadcast of x."""
    if dx is None or dx.shape[0] == x.shape[0]:
        return dx
    return dx.reshape(-1, *x.shape).sum(dim=0)


class _BernoulliFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, logits):
        x, logits = x.detach(), logits.detach()
        ctx.save_for_backward(x, logits)
        return K.bernoulli_cuda(x, logits)

    @staticmethod
    def backward(ctx, g):
        # The backward kernel reads x at the logits' rows: a broadcast x
        # (no path differentiates one) is repeated for it.
        x, logits = ctx.saved_tensors
        dx, dl = K.bernoulli_bwd_cuda(g.contiguous(),
                                      K.expand_rows(x, logits), logits,
                                      want_dx=ctx.needs_input_grad[0])
        return _x_grad(dx, x), dl


class _DiscLogisticFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mean, log_scale, bin_size):
        x, mean, log_scale = x.detach(), mean.detach(), log_scale.detach()
        ctx.save_for_backward(x, mean, log_scale)
        ctx.bin_size = bin_size
        return K.disc_logistic_cuda(x, mean, log_scale, bin_size)

    @staticmethod
    def backward(ctx, g):
        x, mean, log_scale = ctx.saved_tensors
        dx, dmean, dls = K.disc_logistic_bwd_cuda(
            g.contiguous(), K.expand_rows(x, mean), mean, log_scale,
            ctx.bin_size, want_dx=ctx.needs_input_grad[0])
        return _x_grad(dx, x), dmean, dls, None


# ---------------------------------------------------------------------------
# public ops
# ---------------------------------------------------------------------------

def reparam_sample(mean: torch.Tensor, logvar: torch.Tensor,
                   samples: int | None = None, *,
                   generator: torch.Generator | None = None,
                   eps: torch.Tensor | None = None) -> torch.Tensor:
    """z = mean + exp(logvar/2)·eps, eps ~ N(0, I), differentiable in mean
    and logvar.

    ``samples=None`` draws one z of mean's shape; ``samples=S`` draws
    [S, *mean.shape]. The noise comes from ``generator`` (a CPU
    ``torch.Generator``, or the train step's ``K.StepKeys``, whose key the
    kernel reads on the device) through the kernel's Philox stream, on
    either device. ``eps`` injects the noise instead and is accepted only for CPU
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
        z = _ReparamFn.apply(mean.contiguous(), logvar.contiguous(), s,
                             *K.draw_key(generator))
    return z if samples is not None else z[0]


def reparam_kl(mean: torch.Tensor, logvar: torch.Tensor, *,
               generator: torch.Generator | None = None,
               eps: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(z, kl): ``reparam_sample(mean, logvar)`` and ``kl_standard(mean,
    logvar)`` of one posterior, the ELBO's two uses of it.

    On the CPU the two ops as they are. On CUDA one launch draws z (the
    same Philox stream and key as ``reparam_sample`` with this
    ``generator``) and sums the KL, and one launch differentiates both;
    ``eps`` is refused there, as ``reparam_sample`` refuses it."""
    if _on_cpu("reparam_kl", mean, logvar):
        return (reparam_sample(mean, logvar, generator=generator, eps=eps),
                kl_standard(mean, logvar))
    if eps is not None:
        raise ValueError("reparam_kl: eps is accepted only for CPU tensors; "
                         "on CUDA the kernel draws the noise")
    z, kl = _PosteriorFn.apply(mean.contiguous(), logvar.contiguous(), 1,
                               *K.draw_key(generator))
    return z[0], kl


def reparam_prior_kl(q: torch.Tensor, p: torch.Tensor, *,
                     generator: torch.Generator | None = None,
                     eps: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(z, kl) of one layer of a hierarchical VAE: q and p [B, 2Z, H, W]
    are its posterior's and learned prior's (mean, log-sigma) along the
    channels; z = qm + e^qs·eps [B, Z, H, W] and kl [B] the per-image sum
    of KL( N(qm, e^qs) || N(pm, e^ps) ).

    eps is drawn in the order of z's channels_last memory from
    ``reparam_sample``'s Philox stream and key (one key from
    ``generator``). On the CPU the plain version, which autograd
    differentiates; ``eps`` [B, Z, H, W] injects the noise there. On CUDA
    one launch each way, reading q and p in place when they are float32
    in channels_last memory (else from a copy in that layout); ``eps`` is
    refused there."""
    if q.shape != p.shape or q.dim() != 4 or q.shape[1] % 2:
        raise ValueError(f"reparam_prior_kl: q {tuple(q.shape)} and p "
                         f"{tuple(p.shape)} must be alike [B, 2Z, H, W]")
    if _on_cpu("reparam_prior_kl", q, p):
        if eps is not None:
            want = (q.shape[0], q.shape[1] // 2) + tuple(q.shape[2:])
            if tuple(eps.shape) != want:
                raise ValueError(f"reparam_prior_kl: eps has shape "
                                 f"{tuple(eps.shape)}, expected {want}")
            return K.reparam_prior_from_eps(q, p, eps)
        return K.reparam_prior_plain(q, p, *K.draw_key(generator))
    if eps is not None:
        raise ValueError("reparam_prior_kl: eps is accepted only for CPU "
                         "tensors; on CUDA the kernel draws the noise")
    cl = torch.channels_last
    return _PriorPosteriorFn.apply(
        q.to(torch.float32).contiguous(memory_format=cl),
        p.to(torch.float32).contiguous(memory_format=cl),
        *K.draw_key(generator))


def kl_standard(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Per-sample KL(q || N(0, I)), summed over event dims -> [B]."""
    if _on_cpu("kl_standard", mean, logvar):
        return K.kl_plain(mean, logvar)
    return _KLFn.apply(_rows(mean), _rows(logvar))


def bernoulli_recon_ll(x: torch.Tensor, logits: torch.Tensor, *,
                       samples: int = 1) -> torch.Tensor:
    """Per-sample Bernoulli log-likelihood, summed over pixels -> [R].

    x has the logits' shape, or with ``samples=S`` B rows where the logits
    have R = S·B: logits row r is scored against x's row r % B, without
    copying x."""
    _check_samples("bernoulli_recon_ll", x, logits, samples)
    if _on_cpu("bernoulli_recon_ll", x, logits):
        return K.bernoulli_plain(x, logits)
    return _BernoulliFn.apply(_rows(x.to(torch.float32)),
                              _rows(logits.to(torch.float32)))


def disc_logistic_recon_ll(x: torch.Tensor, mean: torch.Tensor,
                           log_scale: torch.Tensor, *,
                           bin_size: float = 1.0 / 255.0,
                           samples: int = 1) -> torch.Tensor:
    """Per-sample discretized-logistic log-likelihood -> [R]; x holds the
    bin centres i/255.

    x has mean's shape, or with ``samples=S`` B rows where mean and
    log_scale have R = S·B: parameter row r is scored against x's row
    r % B, without copying x."""
    _check_samples("disc_logistic_recon_ll", x, mean, samples)
    if _on_cpu("disc_logistic_recon_ll", x, mean, log_scale):
        return K.disc_logistic_plain(x, mean, log_scale, bin_size)
    return _DiscLogisticFn.apply(_rows(x.to(torch.float32)),
                                 _rows(mean.to(torch.float32)),
                                 _rows(log_scale.to(torch.float32)),
                                 float(bin_size))


def disc_logistic_mix_recon_ll(x: torch.Tensor, means: torch.Tensor,
                               log_scales: torch.Tensor,
                               mix_logits: torch.Tensor, *,
                               bin_size: float = 1.0 / 255.0,
                               samples: int = 1) -> torch.Tensor:
    """Per-sample mixture-of-discretized-logistics log-likelihood -> [R];
    x [B, H, W, C] holds the bin centres, the parameters [R, H, W, C, K].

    Plain PyTorch on every device, autograd its backward (the reference's
    jnp tier by design: no TPU kernel). With ``samples=S`` the parameters
    hold R = S·B rows, sample-major, and x is broadcast as a view
    [1, B, ...] against them [S, B, ...]: never copied."""
    _check_samples("disc_logistic_mix_recon_ll", x, means, samples)
    lead = (samples, x.shape[0])
    ll = D.discretized_logistic_mixture_logpmf(
        x.unsqueeze(0), means.reshape(lead + tuple(means.shape[1:])),
        log_scales.reshape(lead + tuple(log_scales.shape[1:])),
        mix_logits.reshape(lead + tuple(mix_logits.shape[1:])),
        bin_size=bin_size)
    return ll.reshape(means.shape[0], -1).sum(dim=-1)
