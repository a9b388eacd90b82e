"""The port's fused ops (``apv_tpu_torch.ops``) against ``apv_tpu``.

On the CPU the ops run their plain PyTorch versions; these tests hold them
to the jnp tier (``apv_tpu.ops.dispatch``) and to the Pallas kernels in
interpret mode (``apv_tpu.ops.kernels``) on the shapes and edge cases of
``tests/test_kernels.py``, and hold the plain backward rules and torch's
autograd of the CPU path to ``jax.grad`` through the reference's
``custom_vjp``s. The CUDA kernels themselves are held to the same plain
versions on the card by ``chip_smoke.py``; the CUDA path's
``autograd.Function``s are rehearsed here with the kernels stood in by
their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apv_tpu.core import distributions as JD
from apv_tpu.ops import dispatch as jdispatch
from apv_tpu.ops import kernels as JK
from apv_tpu_torch import ops
from apv_tpu_torch.ops import kernels as K

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- kl -----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 40), (32, 7, 7, 3), (8, 3072)])
def test_kl_matches_jnp_and_pallas(rng, shape):
    mean = rng.normal(size=shape).astype(np.float32)
    logvar = rng.normal(size=shape).astype(np.float32)
    got = ops.kl_standard(_t(mean), _t(logvar)).numpy()
    # Same f32 elementwise math, different summation order over <= 3072
    # terms of magnitude ~1: rtol 1e-5 as tests/test_kernels.py uses.
    for want in (jdispatch._kl_jnp(mean, logvar), JK.kl(mean, logvar)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("b", [1, 3, 7, 13])
def test_kl_odd_batch_sizes(rng, b):
    mean = rng.normal(size=(b, 40)).astype(np.float32)
    logvar = rng.normal(size=(b, 40)).astype(np.float32)
    got = ops.kl_standard(_t(mean), _t(logvar)).numpy()
    assert got.shape == (b,)
    # f32 sums of 40 terms: tolerance as tests/test_kernels.py
    np.testing.assert_allclose(got, np.asarray(JK.kl(mean, logvar)),
                               rtol=1e-5, atol=1e-4)


# -- bernoulli ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 784), (8, 28, 28, 1), (5, 785)])
def test_bernoulli_matches_jnp_and_pallas(rng, shape):
    x = (rng.random(shape) < 0.3).astype(np.float32)
    logits = (4.0 * rng.normal(size=shape)).astype(np.float32)
    logits.reshape(-1)[:3] = (0.0, 60.0, -60.0)    # softplus' far branches
    got = ops.bernoulli_recon_ll(_t(x), _t(logits)).numpy()
    assert got.shape == (shape[0],)
    # f32 sums of <= 785 terms of magnitude <= 60 (|sum| ~ 1e3), summed in
    # another order: rtol 1e-5 as tests/test_kernels.py, atol 1e-3.
    for want in (jdispatch._bernoulli_jnp(x, logits), JK.bernoulli(x, logits)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-3)


# -- backward rules: plain formulas and CPU autograd against jax.grad --------

def _row_weights(rng, b):
    return rng.normal(size=(b,)).astype(np.float32)


def test_bernoulli_bwd_matches_jax_grad(rng):
    shape = (6, 28, 28, 1)
    x = (rng.random(shape) < 0.4).astype(np.float32)
    logits = (3.0 * rng.normal(size=shape)).astype(np.float32)
    w = _row_weights(rng, 6)
    want_dx, want_dl = jax.grad(
        lambda a, b: jnp.sum(w * JK.bernoulli(a, b)), argnums=(0, 1))(
            x, logits)
    dx, dl = K.bernoulli_bwd_plain(_t(w), _t(x), _t(logits))
    xt = _t(x).requires_grad_()
    lt = _t(logits).requires_grad_()
    (ops.bernoulli_recon_ll(xt, lt) * _t(w)).sum().backward()
    # one f32 sigmoid and product per element: a few ulps of |g·l| <= ~30
    for got, want in ((dx, want_dx), (dl, want_dl), (xt.grad, want_dx),
                      (lt.grad, want_dl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_kl_bwd_matches_jax_grad(rng):
    mean = rng.normal(size=(16, 40)).astype(np.float32)
    logvar = (2.0 * rng.normal(size=(16, 40))).astype(np.float32)
    w = _row_weights(rng, 16)
    want = jax.grad(lambda m, lv: jnp.sum(w * JK.kl(m, lv)),
                    argnums=(0, 1))(mean, logvar)
    plain = K.kl_bwd_plain(_t(w), _t(mean), _t(logvar))
    mt, lt = _t(mean).requires_grad_(), _t(logvar).requires_grad_()
    (ops.kl_standard(mt, lt) * _t(w)).sum().backward()
    # one f32 exp and product per element
    for got, ref in zip((*plain, mt.grad, lt.grad), want + want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("samples", [None, 1, 7])
def test_reparam_bwd_matches_jax_grad(rng, samples):
    """Through JAX's own z: with a sample axis the reference reaches
    ``_unbroadcast`` (mean [B, Z] against a [S, B, Z] logvar), without one
    the plain rule is a sum over an axis of 1."""
    b, z_dim = 8, 5
    mean = rng.normal(size=(b, z_dim)).astype(np.float32)
    logvar = rng.normal(size=(b, z_dim)).astype(np.float32)
    s = samples or 1
    w = rng.normal(size=(s, b, z_dim)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    shape = (b, z_dim) if samples is None else (s, b, z_dim)

    def f(m, lv):
        z = JK.reparam(key, m, jnp.broadcast_to(lv, shape))
        return jnp.sum(w.reshape(shape) * z), z

    (want_dm, want_dlv), z = jax.grad(f, argnums=(0, 1), has_aux=True)(
        mean, logvar)
    z_s = np.asarray(z).reshape(s, b, z_dim)
    dm, dlv = K.reparam_bwd_plain(_t(w), _t(z_s), _t(mean))
    # eps as JAX drew it, so the CPU path's z is JAX's z
    eps = (z_s - mean) / np.exp(0.5 * logvar)
    mt, lt = _t(mean).requires_grad_(), _t(logvar).requires_grad_()
    zt = ops.reparam_sample(mt, lt, samples,
                            eps=_t(eps.reshape(shape).astype(np.float32)))
    (zt * _t(w.reshape(shape))).sum().backward()
    # sums over <= 7 samples of f32 products
    for got, ref in ((dm, want_dm), (dlv, want_dlv), (mt.grad, want_dm),
                     (lt.grad, want_dlv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


# -- the CUDA path's autograd.Functions, kernels stood in by plain versions --

def test_cuda_autograd_functions_detach_and_pair_kernels(monkeypatch):
    """The Functions hand the raw wrappers detached tensors (which refuse
    grad), forward to the forward kernel and backward to the backward
    kernel: each stand-in checks it got no grad-carrying input and counts
    its call."""
    calls = []

    def stand_in(name, fn):
        def wrapper(*args, **kw):
            assert not any(isinstance(a, torch.Tensor) and a.requires_grad
                           for a in args), name
            calls.append(name)
            return fn(*args, **kw)
        monkeypatch.setattr(K, name, wrapper)

    stand_in("bernoulli_cuda", K.bernoulli_plain)
    stand_in("bernoulli_bwd_cuda", lambda g, x, l, want_dx=True: (
        K.bernoulli_bwd_plain(g, x, l)[0] if want_dx else None,
        K.bernoulli_bwd_plain(g, x, l)[1]))
    stand_in("kl_cuda", K.kl_plain)
    stand_in("kl_bwd_cuda", K.kl_bwd_plain)
    stand_in("reparam_cuda", K.reparam_plain)
    stand_in("reparam_bwd_cuda", K.reparam_bwd_plain)
    from apv_tpu_torch.ops import dispatch as Dp

    gen = torch.Generator().manual_seed(0)
    mean0, logvar0 = torch.randn(4, 6, generator=gen), torch.randn(
        4, 6, generator=gen)
    proj = torch.randn(6, 10, generator=gen)
    x = (torch.rand(4, 10, generator=gen) < 0.5).float()

    def objective(reparam, kl_fn, bern):
        mean = mean0.clone().requires_grad_()
        logvar = logvar0.clone().requires_grad_()
        z = reparam(mean, logvar, 3, 11, 5)
        logits = (z.sum(0) @ proj).contiguous()
        (bern(x, logits).sum() - kl_fn(mean, logvar).sum()).backward()
        return mean.grad, logvar.grad

    got = objective(Dp._ReparamFn.apply, Dp._KLFn.apply,
                    Dp._BernoulliFn.apply)
    assert sorted(calls) == sorted(
        ["reparam_cuda", "kl_cuda", "bernoulli_cuda", "bernoulli_bwd_cuda",
         "kl_bwd_cuda", "reparam_bwd_cuda"])
    # the same graph through the plain forward ops and autograd
    want = objective(K.reparam_plain, K.kl_plain, K.bernoulli_plain)
    for g, w in zip(got, want):
        # the same f32 products summed in another order
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# -- disc_logistic ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 3072), (6, 32, 32, 3)])
def test_disc_logistic_matches_jnp_and_pallas(rng, shape):
    x = (rng.integers(0, 256, size=shape) / 255.0).astype(np.float32)
    mean = rng.uniform(-0.2, 1.2, size=shape).astype(np.float32)
    ls = rng.uniform(-7, 0, size=shape).astype(np.float32)
    got = ops.disc_logistic_recon_ll(_t(x), _t(mean), _t(ls)).numpy()
    # f32 sums of 3072 log-pmf terms (|sum| ~ 1e4): the reference's own
    # bar for these shapes, rtol 1e-5 / atol 1e-3.
    for want in (jdispatch._disc_logistic_jnp(x, mean, ls, 1 / 255.0),
                 JK.disc_logistic(x, mean, ls, 1 / 255.0)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-3)


def test_disc_logistic_elementwise_edges_and_scales(rng):
    """Edge bins, the -7 floor and both log-expm1 branches, elementwise."""
    shape = (8, 128)
    x = (rng.integers(0, 256, size=shape) / 255.0).astype(np.float32)
    x[0, :4] = 0.0          # low edge bin
    x[1, :4] = 1.0          # high edge bin
    mean = rng.uniform(-0.2, 1.2, size=shape).astype(np.float32)
    ls = rng.uniform(-7, -0.5, size=shape).astype(np.float32)
    ls[2, :] = -7.0         # the decoder's floor
    ls[3, :] = 3.0          # t = bin/s < 1e-3: the small-t branch
    from apv_tpu_torch.core import distributions as TD
    got = TD.discretized_logistic_logpmf(_t(x), _t(mean), _t(ls)).numpy()
    want = np.asarray(JD.discretized_logistic_logpmf(x, mean, ls))
    # elementwise f32 transcendental chains: a few ulps of |value| <= ~40
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def _disc_logistic_bwd_inputs(rng, rows=6, event=512):
    """Every level (both edge bins among them), the decoder's −7 floor,
    log-scales where t = bin/s ≤ 1e-4 (the rule's series) and around it."""
    x = rng.integers(0, 256, size=(rows, event)) / 255.0
    x[0, :256] = np.arange(256) / 255.0
    x[1, :256] = np.arange(256) / 255.0
    mean = rng.uniform(-0.2, 1.2, size=(rows, event))
    ls = rng.uniform(-7.0, 0.0, size=(rows, event))
    ls[1] = -7.0                                   # every level at the floor
    ls[2] = rng.uniform(5.0, 5.5, size=event)      # t ~ 2e-5: the series
    ls[3] = rng.uniform(3.4, 4.0, size=event)      # t around 1e-4
    ls[4] = rng.uniform(-2.0, 3.0, size=event)
    g = rng.normal(size=rows)
    return tuple(v.astype(np.float32) for v in (g, x, mean, ls))


def _disc_logistic_bwd_bar(g, x, mean, ls, rel, autograd=False):
    """rel·|g|·(1 + e^-ls + |a| + |b|): ``rel`` of the largest f32 term each
    gradient is made of (dmean sums inv_s·(1, σ(a), σ(b)); dlog_scale sums
    a·σ(a), b·(1 − σ(b)) and a t-term ≤ 1 + t, and at the −7 floor |a|, |b|
    reach ~10³ and cancel).

    ``autograd``: torch's autograd of the plain forward, against the rule,
    also carries the forward's own rounding. For t > 1e-3 the forward takes
    log(expm1(t)) as t + log1p(−e^{−t}), whose 1 − e^{−t} loses log10(1/t)
    digits; its derivative, and so the t-term, is off by up to ~ε/t (6e-5
    just above the branch point). The bar adds 1e-7·|g|/t there."""
    xd, md, sd = (v.astype(np.float64) for v in (x, mean, ls))
    inv_s = np.exp(-sd)
    half = 0.5 / 255.0
    a, b = (xd - md + half) * inv_s, (xd - md - half) * inv_s
    gd = np.abs(g.astype(np.float64))[:, None]
    bar = rel * gd * (1.0 + inv_s + np.abs(a) + np.abs(b))
    if autograd:
        t = inv_s / 255.0
        bar = bar + np.where(t > 1e-3, 1e-7 * gd / t, 0.0)
    return bar


@pytest.mark.parametrize("reference", ["rule", "vjp", "autograd"])
def test_disc_logistic_bwd_matches_jax(rng, reference):
    """``disc_logistic_bwd_plain`` against ``_disc_logistic_bwd`` called
    directly, against ``jax.vjp`` of the custom_vjp op (its Pallas forward
    in interpret mode), and torch's autograd of the plain forward (the CPU
    path's gradient) against the rule."""
    g, x, mean, ls = _disc_logistic_bwd_inputs(rng)
    got = K.disc_logistic_bwd_plain(_t(g), _t(x), _t(mean), _t(ls))
    rule = JK._disc_logistic_bwd(1 / 255.0, (x, mean, ls), g)
    if reference == "rule":
        want = rule
    elif reference == "vjp":
        _, vjp = jax.vjp(lambda a, m, s: JK.disc_logistic(a, m, s,
                                                          1 / 255.0),
                         x, mean, ls)
        want = vjp(g)
    else:
        xt, mt, st = (_t(v).requires_grad_() for v in (x, mean, ls))
        (ops.disc_logistic_recon_ll(xt, mt, st) * _t(g)).sum().backward()
        got, want = (xt.grad, mt.grad, st.grad), rule
    # the same f32 formulas through two libms: within 1e-6 (~16 ulps) of
    # the largest term; autograd's series for 1e-4 < t <= 1e-3 differs from
    # the rule's by t²/3 <= 3.4e-7, inside that bar too, and its big-t
    # branch carries the forward's cancellation (see the bar)
    bar = _disc_logistic_bwd_bar(g, x, mean, ls, 1e-6,
                                 autograd=reference == "autograd")
    for name, a, b in zip(("dx", "dmean", "dlog_scale"), got, want):
        err = np.abs(a.numpy().astype(np.float64) - np.asarray(b, np.float64))
        assert (err <= bar).all(), (name, float((err / bar).max()))
    assert np.isfinite(np.asarray(want[2])).all()


def test_disc_logistic_pmf_sums_to_one():
    """Closed form: the 256 bins' probabilities sum to 1."""
    levels = torch.arange(256, dtype=torch.float32) / 255.0
    for mu, ls in ((0.3, -3.0), (0.95, -5.0), (-0.1, -1.0), (0.5, -7.0)):
        ll = ops.disc_logistic_recon_ll(
            levels[:, None], torch.full((256, 1), mu),
            torch.full((256, 1), ls))
        # f32 log-pmf exponentiated and summed over 256 bins
        assert abs(float(torch.exp(ll.double()).sum()) - 1.0) < 1e-4


# -- reparam ------------------------------------------------------------------

def test_reparam_injected_eps_matches_gaussian_sample(rng):
    mean = rng.normal(size=(16, 8)).astype(np.float32)
    logvar = rng.normal(size=(16, 8)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(JD.gaussian_sample(key, mean, logvar,
                                         sample_shape=(10,)))
    eps = np.asarray(jax.random.normal(key, (10, 16, 8), dtype=np.float32))
    got = ops.reparam_sample(_t(mean), _t(logvar), 10, eps=_t(eps)).numpy()
    # one f32 exp and fma per element
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="eps has shape"):
        ops.reparam_sample(_t(mean), _t(logvar), 9, eps=_t(eps))


def test_reparam_moments():
    """The Philox + Box-Muller stream (the kernel's, in plain PyTorch):
    mean, variance, 1σ mass 0.6827 and no correlation between the two
    outputs of one Box-Muller pair."""
    mean = torch.tensor([[1.5, -2.0]])
    logvar = torch.tensor([[0.5, -1.0]])
    gen = torch.Generator().manual_seed(3)
    z = ops.reparam_sample(mean, logvar, 500_000, generator=gen)[:, 0]
    eps = (z - mean) / torch.exp(0.5 * logvar)           # [S, 2]
    # 5e5 draws per column: SEs 0.0014 (mean), 0.002 (variance), 0.0005
    # (1σ mass over both columns), 0.0014 (correlation); bars at 4-5 SE.
    np.testing.assert_allclose(eps.mean(0).numpy(), [0.0, 0.0], atol=0.006)
    np.testing.assert_allclose(eps.var(0).numpy(), [1.0, 1.0], atol=0.008)
    frac = float((eps.abs() < 1.0).double().mean())
    assert abs(frac - 0.6827) < 0.0025
    corr = float(torch.corrcoef(eps.T)[0, 1])
    assert abs(corr) < 0.006            # the two Box-Muller outputs


def test_reparam_deterministic_in_generator():
    mean = torch.zeros(64, 8)
    logvar = torch.zeros(64, 8)

    def draw(seed):
        return ops.reparam_sample(mean, logvar, 3,
                                  generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(draw(7), draw(7), rtol=0, atol=0)
    assert not torch.equal(draw(7), draw(8))
    gen = torch.Generator().manual_seed(7)
    a = ops.reparam_sample(mean, logvar, generator=gen)
    b = ops.reparam_sample(mean, logvar, generator=gen)
    assert a.shape == (64, 8) and not torch.equal(a, b)   # successive calls


def test_philox_known_answers():
    """Philox4x32-10 against the Random123 known-answer vectors."""
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = K.philox4x32_10(tuple(torch.tensor([c]) for c in ctr), key)
        assert tuple(int(w) for w in got) == want


# -- the CUDA wrappers' guards (runnable without a card) ----------------------

WRAPPER_CALLS = {
    # name -> call(grad-carrying [4, 8] tensor, plain [4, 8], plain [4])
    "kl": lambda m, lv, g: K.kl_cuda(m, lv),
    "reparam": lambda m, lv, g: K.reparam_cuda(m, lv, 2, 0, 0),
    "disc_logistic": lambda m, lv, g: K.disc_logistic_cuda(lv, m, lv),
    "bernoulli": lambda m, lv, g: K.bernoulli_cuda(lv, m),
    "bernoulli_bwd": lambda m, lv, g: K.bernoulli_bwd_cuda(g, lv, m),
    "kl_bwd": lambda m, lv, g: K.kl_bwd_cuda(g, m, lv),
    "reparam_bwd": lambda m, lv, g: K.reparam_bwd_cuda(m[None], lv[None],
                                                       lv),
    "disc_logistic_bwd": lambda m, lv, g: K.disc_logistic_bwd_cuda(g, lv, m,
                                                                   lv),
}


@pytest.mark.parametrize("name", sorted(WRAPPER_CALLS))
def test_cuda_wrappers_refuse_grad_and_cpu_tensors(name):
    m = torch.zeros(4, 8, requires_grad=True)
    lv = torch.zeros(4, 8)
    g = torch.zeros(4)
    call = WRAPPER_CALLS[name]
    with pytest.raises(RuntimeError, match="forward only"):
        call(m, lv, g)
    with pytest.raises(ValueError, match="plain version takes CPU"):
        call(lv.clone(), lv, g)
    with pytest.raises(ValueError, match="all on one CUDA device"):
        ops.kl_standard(lv, torch.zeros(4, 8, device="meta"))


def test_disc_logistic_grad_on_cuda_is_not_ported_yet(monkeypatch):
    """The CUDA path of ``disc_logistic_recon_ll`` is an autograd.Function
    of the forward and backward kernels (``_DiscLogisticFn``; ported with
    the CIFAR training slice), rehearsed with the kernels stood in by their
    plain versions: both get detached tensors, dx is asked for only when x
    requires grad, and the gradients equal torch's autograd of the plain
    forward."""
    from apv_tpu_torch.ops import dispatch as Dp
    calls = []

    def fwd(x, m, s, bin_size):
        assert not any(t.requires_grad for t in (x, m, s))
        calls.append("disc_logistic_cuda")
        return K.disc_logistic_plain(x, m, s, bin_size)

    def bwd(g, x, m, s, bin_size, *, want_dx=True):
        assert not any(t.requires_grad for t in (g, x, m, s))
        calls.append(("disc_logistic_bwd_cuda", want_dx))
        dx, dm, ds = K.disc_logistic_bwd_plain(g, x, m, s, bin_size)
        return (dx if want_dx else None), dm, ds

    monkeypatch.setattr(K, "disc_logistic_cuda", fwd)
    monkeypatch.setattr(K, "disc_logistic_bwd_cuda", bwd)
    rng = np.random.default_rng(8)
    g, x, mean, ls = _disc_logistic_bwd_inputs(rng, rows=5, event=256)
    shape = (5, 8, 8, 4)                    # NHWC rows flattened by the op

    def grads(on_cuda, x_grad):
        monkeypatch.setattr(Dp, "_on_cpu", lambda name, *t: not on_cuda)
        xt = _t(x.reshape(shape)).requires_grad_(x_grad)
        mt, st = (_t(v.reshape(shape)).requires_grad_() for v in (mean, ls))
        (ops.disc_logistic_recon_ll(xt, mt, st) * _t(g)).sum().backward()
        return xt.grad, mt.grad, st.grad

    for x_grad in (False, True):
        calls.clear()
        got = grads(True, x_grad)
        assert calls == ["disc_logistic_cuda",
                         ("disc_logistic_bwd_cuda", x_grad)]
        want = grads(False, x_grad)
        assert (got[0] is None) == (not x_grad)
        bar = _disc_logistic_bwd_bar(g, x, mean, ls, 1e-6,
                                     autograd=True).reshape(shape)
        for a, b in zip(got, want):
            if b is not None:
                err = (a - b).abs().numpy()
                assert (err <= bar).all(), float((err / bar).max())
