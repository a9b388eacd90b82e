"""The likelihood ops with x broadcast over samples, against ``apv_tpu``.

``ops.bernoulli_recon_ll`` and ``ops.disc_logistic_recon_ll`` take x with
B rows beside parameters with R = S·B rows where the caller names S
(``samples=S``; parameter row r reads x's row r % B), so that the IWAE and
OOD paths score each image under S posterior samples without a [S·B, E]
copy of x. These tests hold that call to the same op on x expanded, value
and gradient, on the CPU path and on the CUDA path's
``autograd.Function``s rehearsed with the kernels stood in by their plain
versions (stand-ins that refuse what the kernels refuse); dx of the
broadcast to ``jax.grad`` through ``jnp.broadcast_to`` of the reference's
Pallas ops in interpret mode; the refusal when R is not S·B (S = 1 unless
the caller says otherwise) and, in the kernel wrappers, when B does not
divide R; and ``make_logw_chunk_fn`` handing the op x with B rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apv_tpu.ops import kernels as JK
from apv_tpu_torch import ops
from apv_tpu_torch.eval.iwae_eval import make_logw_chunk_fn
from apv_tpu_torch.ops import dispatch as Dp
from apv_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

BIN = 1.0 / 255.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(rng, kind, samples, b, event):
    """x [B, event] and the parameters [S·B, event], f32; the disc-logistic
    log-scales in [-2, 0] keep every gradient term O(10), where 1e-5 abs
    is a few ulps."""
    rows = samples * b
    if kind == "bernoulli":
        x = (rng.random((b, event)) < 0.3).astype(np.float32)
        logits = (3.0 * rng.normal(size=(rows, event))).astype(np.float32)
        return x, (logits,)
    x = (rng.integers(0, 256, size=(b, event)) / 255.0).astype(np.float32)
    x[0, :2] = (0.0, 1.0)                         # both edge bins
    mean = (np.tile(x, (samples, 1))
            + rng.normal(scale=0.1, size=(rows, event))).astype(np.float32)
    ls = rng.uniform(-2.0, 0.0, size=(rows, event)).astype(np.float32)
    return x, (mean, ls)


def _op(kind):
    return ops.bernoulli_recon_ll if kind == "bernoulli" \
        else ops.disc_logistic_recon_ll


def _stand_ins(monkeypatch):
    """The CUDA path with each kernel stood in by its plain version: the
    forwards take x [B, E] (and assert they got it unexpanded), the
    backwards x at the parameters' rows, as the kernels do."""
    seen = []

    def fwd(plain):
        def run(x, *params):
            assert not any(t.requires_grad for t in (x, *params)
                           if isinstance(t, torch.Tensor))
            seen.append(("fwd", x.shape[0], params[0].shape[0]))
            return plain(x, *params)
        return run

    def bern_bwd(g, x, logits, *, want_dx=True):
        assert x.shape == logits.shape
        seen.append(("bwd", want_dx))
        dx, dl = K.bernoulli_bwd_plain(g, x, logits)
        return (dx if want_dx else None), dl

    def disc_bwd(g, x, mean, ls, bin_size, *, want_dx=True):
        assert x.shape == mean.shape
        seen.append(("bwd", want_dx))
        dx, dm, ds = K.disc_logistic_bwd_plain(g, x, mean, ls, bin_size)
        return (dx if want_dx else None), dm, ds

    monkeypatch.setattr(Dp, "_on_cpu", lambda name, *t: False)
    monkeypatch.setattr(K, "bernoulli_cuda", fwd(K.bernoulli_plain))
    monkeypatch.setattr(K, "disc_logistic_cuda", fwd(K.disc_logistic_plain))
    monkeypatch.setattr(K, "bernoulli_bwd_cuda", bern_bwd)
    monkeypatch.setattr(K, "disc_logistic_bwd_cuda", disc_bwd)
    return seen


def _value_and_grads(kind, x, params, g, x_grad, samples=1):
    xt = _t(x).requires_grad_(x_grad)
    pt = [_t(p).requires_grad_() for p in params]
    ll = _op(kind)(xt, *pt, samples=samples)
    (ll * _t(g)).sum().backward()
    return ll.detach(), xt.grad, [p.grad for p in pt]


@pytest.mark.parametrize("path", ["cpu", "cuda_rehearsed"])
@pytest.mark.parametrize("samples,event", [(1, 64), (3, 64), (3, 37)])
@pytest.mark.parametrize("kind", ["bernoulli", "disc_logistic"])
def test_broadcast_x_equals_expanded_x(rng, monkeypatch, kind, samples,
                                       event, path):
    """B = R, S = 3, and a row length that is not a multiple of 4."""
    b = 4
    x, params = _inputs(rng, kind, samples, b, event)
    g = rng.normal(size=samples * b).astype(np.float32)
    seen = _stand_ins(monkeypatch) if path == "cuda_rehearsed" else []
    want = _value_and_grads(kind, np.tile(x, (samples, 1)), params, g, False)
    got = _value_and_grads(kind, x, params, g, False, samples)
    if path == "cuda_rehearsed":
        rows = samples * b
        assert seen == [("fwd", rows, rows), ("bwd", False),
                        ("fwd", b, rows), ("bwd", False)]
    # the same f32 elementwise terms summed in the same order
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    assert got[1] is None
    for a, w in zip(got[2], want[2]):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


@pytest.mark.parametrize("path", ["cpu", "cuda_rehearsed"])
@pytest.mark.parametrize("kind", ["bernoulli", "disc_logistic"])
def test_broadcast_dx_matches_jax_grad(rng, monkeypatch, kind, path):
    """dx of the broadcast x is the sum over samples of each row's dx, as
    ``jax.grad`` gives through ``jnp.broadcast_to`` of the reference op
    (its Pallas forward in interpret mode, its custom_vjp rule)."""
    samples, b, event = 3, 4, 48
    x, params = _inputs(rng, kind, samples, b, event)
    g = rng.normal(size=samples * b).astype(np.float32)

    def ref(xa, *pa):
        xb = jnp.broadcast_to(xa[None], (samples,) + xa.shape).reshape(
            (samples * b, event))
        ll = (JK.bernoulli(xb, *pa) if kind == "bernoulli"
              else JK.disc_logistic(xb, *pa, BIN))
        return jnp.sum(g * ll)

    want = jax.grad(ref, argnums=tuple(range(1 + len(params))))(x, *params)
    if path == "cuda_rehearsed":
        _stand_ins(monkeypatch)
    _, dx, dparams = _value_and_grads(kind, x, params, g, True, samples)
    assert dx.shape == (b, event)
    # sums of S = 3 f32 gradient terms of magnitude O(10): 1e-5 abs. On
    # the CPU, dlog_scale is torch's autograd of the plain forward, whose
    # t + log1p(-e^-t) loses ~eps/t in its t-term against the reference's
    # rule (tests/test_torch_ops.py::_disc_logistic_bwd_bar): 1e-7·|g|/t
    # more there.
    bars = [1e-5] * (1 + len(params))
    if kind == "disc_logistic" and path == "cpu":
        t = np.exp(-params[1].astype(np.float64)) * BIN
        bars[2] = 1e-5 + 1e-7 * np.abs(g.astype(np.float64))[:, None] / t
    for name, a, w, bar in zip(("dx", "dparam", "dlog_scale"),
                               (dx, *dparams), want, bars):
        err = np.abs(a.numpy().astype(np.float64) - np.asarray(w, np.float64))
        assert (err <= bar).all(), (name, float((err / bar).max()))


@pytest.mark.parametrize("path", ["cpu", "cuda_rehearsed"])
@pytest.mark.parametrize("kind", ["bernoulli", "disc_logistic"])
def test_rows_that_b_does_not_divide_raise(rng, monkeypatch, kind, path):
    """The ops score x's B rows under S samples only where the caller
    says so: R = S·B, S = 1 by default, so a row count that divides the
    parameters' (x with 4 rows beside 12) raises unless samples=3; the
    kernel wrappers take any B that divides R."""
    x, params = _inputs(rng, kind, 3, 4, 16)
    if path == "cuda_rehearsed":
        _stand_ins(monkeypatch)
    op, pt = _op(kind), list(map(_t, params))
    assert op(_t(x), *pt, samples=3).shape == (12,)
    for xs, samples in ((x, 1),                          # 4 rows beside 12
                        (x[:3], 3),                      # 3 divides 12
                        (np.concatenate([x, x[:1]]), 3),  # B = 5
                        (x, 0),
                        (x[:, :15], 3)):                 # another length
        with pytest.raises(ValueError, match="does not pair"):
            op(_t(xs), *pt, samples=samples)
    with pytest.raises(ValueError, match="does not pair"):
        K._x_rows(kind, torch.zeros(5, 16), torch.zeros(12, 16))
    assert K._x_rows(kind, torch.zeros(4, 16), torch.zeros(12, 16)) == 4


@pytest.mark.parametrize("likelihood", ["bernoulli", "discretized_logistic"])
def test_logw_chunk_hands_the_op_x_with_b_rows(monkeypatch, likelihood):
    """``make_logw_chunk_fn`` passes x_target itself ([B, ...], no
    [chunk·B, ...] copy) beside the chunk's [chunk·B, ...] parameters, and
    its log-weights equal those with x expanded."""
    b, chunk, z_dim, shape = 3, 5, 4, (6, 6, 1)
    gen = torch.Generator().manual_seed(0)
    channels = 1 if likelihood == "bernoulli" else 2
    proj = torch.randn(z_dim, 36 * channels, generator=gen)

    def decode(z):
        return (z @ proj).reshape(z.shape[0], *shape[:2], channels)

    if likelihood == "bernoulli":
        x = (torch.rand((b, *shape), generator=gen) < 0.5).float()
    else:
        x = torch.randint(0, 256, (b, *shape), generator=gen) / 255.0
    mean, logvar = torch.randn(b, z_dim, generator=gen), torch.zeros(b, z_dim)
    eps = torch.randn(chunk, b, z_dim, generator=gen)
    name = ("bernoulli_recon_ll" if likelihood == "bernoulli"
            else "disc_logistic_recon_ll")
    op, seen = getattr(ops, name), []

    def spy(xt, *params, **kw):
        seen.append((xt, params[0].shape[0], kw.get("samples")))
        return op(xt, *params, **kw)

    monkeypatch.setattr(ops, name, spy)
    logw = make_logw_chunk_fn(decode, likelihood, chunk)(mean, logvar, x,
                                                         eps=eps)
    ((xt, rows, samples),) = seen
    assert xt.shape[0] == b and rows == chunk * b and samples == chunk
    assert xt.data_ptr() == x.data_ptr()
    monkeypatch.setattr(ops, name, op)
    out = decode((mean + eps).reshape(chunk * b, z_dim))
    from apv_tpu_torch.training.losses import recon_log_likelihood
    want = recon_log_likelihood(x.repeat(chunk, 1, 1, 1), out,
                                likelihood).reshape(chunk, b)
    from apv_tpu_torch.core import distributions as D
    z = mean + eps
    want = (want + D.standard_gaussian_logpdf(z).sum(-1)
            - D.gaussian_logpdf(z, mean, logvar).sum(-1))
    torch.testing.assert_close(logw, want, rtol=0, atol=0)
