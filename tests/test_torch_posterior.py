"""``ops.reparam_kl``, the ELBO's posterior op (z and its KL(q || N(0, I))
from one posterior), against ``apv_tpu``'s ``reparam`` and ``kl``.

On the CPU the op is the pair ``reparam_sample`` + ``kl_standard`` as they
are; these tests hold its values and the gradients of scalars that use z
and the KL (and z alone) to ``jax.grad`` through the reference's
``custom_vjp``s, with JAX's own draws injected as eps. The IWAE objective's
S = 5 goes through ``reparam_sample`` beside ``kl_standard``. The fused
kernels are held to the plain versions on the card by ``chip_smoke.py``;
the CUDA path's ``autograd.Function`` is rehearsed in ``test_torch_ops``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apv_tpu.ops import kernels as JK
from apv_tpu_torch import ops
from apv_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

SHAPES = [(16, 40), (7, 128), (3, 13)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(rng, shape, samples):
    mean = rng.normal(size=shape).astype(np.float32)
    logvar = rng.uniform(-3.0, 1.0, size=shape).astype(np.float32)
    w = rng.normal(size=(samples,) + shape).astype(np.float32)
    w_kl = rng.normal(size=shape[0]).astype(np.float32)
    return mean, logvar, w, w_kl


def _reference(mean, logvar, w, w_kl, samples, with_kl):
    """jax.grad of sum(w·z) (+ sum(w_kl·kl)) through JK.reparam and JK.kl,
    with z [S, B, Z] drawn by JAX; returns ((dmean, dlogvar), z, kl)."""
    key = jax.random.PRNGKey(3)
    shape = (samples,) + mean.shape

    def f(m, lv):
        z = JK.reparam(key, m, jnp.broadcast_to(lv, shape))
        kl = JK.kl(m, lv)
        obj = jnp.sum(w * z)
        if with_kl:
            obj = obj + jnp.sum(w_kl * kl)
        return obj, (z, kl)

    grads, (z, kl) = jax.grad(f, argnums=(0, 1), has_aux=True)(mean, logvar)
    return grads, np.asarray(z), np.asarray(kl)


def _assert_grads(got, want):
    # sums over <= 5 samples of f32 products plus one f32 exp product per
    # element: the existing reparam/kl gradient tests' 1e-5
    for g, ref in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def _assert_kl(kl, ref):
    # per-row f32 sums of up to 128 terms of magnitude ~1 in another
    # order: 1.5e-5 absolute plus 1e-5 of the sum's size
    np.testing.assert_allclose(kl.detach().numpy(), ref, rtol=1e-5,
                               atol=1.5e-5)


@pytest.mark.parametrize("with_kl", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_reparam_kl_matches_reference(rng, shape, with_kl):
    """S = 1: z, the KL and the gradients of a scalar of both (of z
    alone: the KL unused, as under free bits)."""
    mean, logvar, w, w_kl = _inputs(rng, shape, 1)
    want, z_ref, kl_ref = _reference(mean, logvar, w, w_kl, 1, with_kl)
    eps = (z_ref[0] - mean) / np.exp(0.5 * logvar)    # JAX's draws
    mt, lt = _t(mean).requires_grad_(), _t(logvar).requires_grad_()
    z, kl = ops.reparam_kl(mt, lt, eps=_t(eps.astype(np.float32)))
    assert z.shape == shape and kl.shape == (shape[0],)
    # one f32 exp and fma per element
    np.testing.assert_allclose(z.detach().numpy(), z_ref[0], rtol=1e-6,
                               atol=1e-6)
    _assert_kl(kl, kl_ref)
    obj = (z * _t(w[0])).sum()
    if with_kl:
        obj = obj + (kl * _t(w_kl)).sum()
    obj.backward()
    _assert_grads((mt.grad, lt.grad), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_iwae_samples_through_reparam_sample(rng, shape):
    """The IWAE objective's S = 5 draws through ``reparam_sample`` beside
    ``kl_standard`` of the same posterior, against the reference's pair."""
    s = 5
    mean, logvar, w, w_kl = _inputs(rng, shape, s)
    want, z_ref, kl_ref = _reference(mean, logvar, w, w_kl, s, True)
    eps = (z_ref - mean) / np.exp(0.5 * logvar)
    mt, lt = _t(mean).requires_grad_(), _t(logvar).requires_grad_()
    z = ops.reparam_sample(mt, lt, s, eps=_t(eps.astype(np.float32)))
    kl = ops.kl_standard(mt, lt)
    np.testing.assert_allclose(z.detach().numpy(), z_ref, rtol=1e-6,
                               atol=1e-6)
    _assert_kl(kl, kl_ref)
    ((z * _t(w)).sum() + (kl * _t(w_kl)).sum()).backward()
    _assert_grads((mt.grad, lt.grad), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_reparam_kl_on_cpu_is_the_pair(rng, shape):
    """The CPU path is ``reparam_sample`` and ``kl_standard`` as they are:
    the same bits from the same generator state, values and gradients."""
    mean, logvar, w, w_kl = _inputs(rng, shape, 1)

    def run(fused):
        mt, lt = _t(mean).requires_grad_(), _t(logvar).requires_grad_()
        gen = torch.Generator().manual_seed(11)
        if fused:
            z, kl = ops.reparam_kl(mt, lt, generator=gen)
        else:
            z = ops.reparam_sample(mt, lt, generator=gen)
            kl = ops.kl_standard(mt, lt)
        ((z * _t(w[0])).sum() + (kl * _t(w_kl)).sum()).backward()
        return z.detach(), kl.detach(), mt.grad, lt.grad

    for a, b in zip(run(True), run(False)):
        assert torch.equal(a, b)


def test_reparam_kl_plain_rules_match_reference(rng):
    """``reparam_kl_plain`` and ``reparam_bwd_plain`` with the KL's row
    gradient (the plain versions the kernels are held to on the card)
    against the reference's forward values and ``jax.grad``; without the
    KL's gradient the rule is ``_reparam_bwd``'s, without z's it is
    ``_kl_bwd``'s."""
    shape, s = (7, 128), 5
    mean, logvar, w, w_kl = _inputs(rng, shape, s)
    want, z_ref, kl_ref = _reference(mean, logvar, w, w_kl, s, True)
    m, lv = _t(mean), _t(logvar)
    z, kl = K.reparam_kl_plain(m, lv, s, 5, 9)
    torch.testing.assert_close(z, K.reparam_plain(m, lv, s, 5, 9), rtol=0,
                               atol=0)
    _assert_kl(kl, kl_ref)
    _assert_grads(K.reparam_bwd_plain(_t(w), _t(z_ref), m, _t(w_kl), lv),
                  want)
    want_z, _, _ = _reference(mean, logvar, w, w_kl, s, False)
    _assert_grads(K.reparam_bwd_plain(_t(w), _t(z_ref), m), want_z)
    dm, dlv = K.reparam_bwd_plain(None, _t(z_ref), m, _t(w_kl), lv)
    want_kl = jax.grad(lambda a, b: jnp.sum(w_kl * JK.kl(a, b)),
                       argnums=(0, 1))(mean, logvar)
    _assert_grads((dm, dlv), want_kl)


def test_reparam_kl_refuses_eps_on_cuda_path(monkeypatch):
    """Off the CPU the noise is the kernel's: an injected eps is refused
    before anything launches."""
    from apv_tpu_torch.ops import dispatch as Dp
    monkeypatch.setattr(Dp, "_on_cpu", lambda name, *t: False)
    m = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="eps is accepted only for CPU"):
        ops.reparam_kl(m, m, eps=torch.zeros(4, 8))
