"""Golden tests of the port's ``core/distributions.py`` against scipy: the
cases of ``tests/test_distributions.py`` run through the port's functions
(the reparameterized draws through ``ops.reparam_sample`` on the CPU, the
port's counterpart of ``gaussian_sample``), at the same tolerances."""

import numpy as np
import scipy.stats as sps
import torch

from apv_tpu_torch import ops
from apv_tpu_torch.core import distributions as D

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _draws(mean, logvar, n, seed):
    """[n, *mean.shape] reparameterized draws, differentiable."""
    gen = torch.Generator().manual_seed(seed)
    return ops.reparam_sample(mean, logvar, n, generator=gen)


def test_gaussian_logpdf_matches_scipy(rng):
    z = rng.normal(size=(64,)).astype(np.float32) * 3
    mean = rng.normal(size=(64,)).astype(np.float32)
    logvar = rng.normal(size=(64,)).astype(np.float32)
    got = D.gaussian_logpdf(_t(z), _t(mean), _t(logvar)).numpy()
    want = sps.norm.logpdf(z, loc=mean, scale=np.exp(0.5 * logvar))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_standard_gaussian_logpdf(rng):
    z = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(D.standard_gaussian_logpdf(_t(z)).numpy(),
                               sps.norm.logpdf(z), rtol=1e-5, atol=1e-5)


def test_gaussian_kl_standard_analytic_vs_mc():
    mean = _t([0.5, -1.0, 0.0])
    logvar = _t([0.3, -0.7, 0.0])
    analytic = D.gaussian_kl_standard(mean, logvar)
    # KL(N(0,1)||N(0,1)) = 0 exactly
    np.testing.assert_allclose(float(analytic[2]), 0.0, atol=1e-7)
    z = _draws(mean, logvar, 200_000, seed=0)
    mc = torch.mean(D.gaussian_logpdf(z, mean, logvar)
                    - D.standard_gaussian_logpdf(z), dim=0)
    np.testing.assert_allclose(analytic.numpy(), mc.numpy(), rtol=0.05,
                               atol=0.01)


def test_gaussian_kl_general_reduces_to_standard(rng):
    mean = rng.normal(size=(16,)).astype(np.float32)
    logvar = rng.normal(size=(16,)).astype(np.float32)
    got = D.gaussian_kl(_t(mean), _t(logvar), torch.zeros(16),
                        torch.zeros(16))
    want = D.gaussian_kl_standard(_t(mean), _t(logvar))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_reparam_sample_statistics():
    mean = _t([1.5, -2.0])
    logvar = _t([0.5, -1.0])
    z = _draws(mean, logvar, 400_000, seed=42)
    np.testing.assert_allclose(z.mean(0).numpy(), mean.numpy(), atol=0.01)
    np.testing.assert_allclose(z.var(0, unbiased=False).numpy(),
                               np.exp(logvar.numpy()), rtol=0.02)


def test_reparam_gradient_flows():
    # d/d mean E[z] = 1
    mean = torch.tensor(0.3, requires_grad=True)
    logvar = torch.tensor(-0.2, requires_grad=True)
    z = _draws(mean, logvar, 100_000, seed=1)
    (g,) = torch.autograd.grad(z.mean(), mean)
    np.testing.assert_allclose(float(g), 1.0, atol=1e-4)


def test_bernoulli_logpmf_matches_scipy(rng):
    logits = rng.normal(size=(64,)).astype(np.float32) * 8
    x = (rng.random(64) < 0.5).astype(np.float32)
    got = D.bernoulli_logpmf(_t(x), _t(logits)).numpy()
    p = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    want = sps.bernoulli.logpmf(x.astype(int), p)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bernoulli_extreme_logits_finite():
    out = D.bernoulli_logpmf(_t([0.0, 1.0, 1.0]), _t([-500.0, 500.0, 0.0]))
    assert np.all(np.isfinite(out.numpy()))
    np.testing.assert_allclose(float(out[2]), np.log(0.5), rtol=1e-5)


# ---------------------------------------------------------------------------
# Discretized logistic
# ---------------------------------------------------------------------------

def _scipy_disc_logistic(x, mean, log_scale, bin_size=1 / 255., low=0.,
                         high=1.):
    """Direct CDF difference in float64 as the golden reference."""
    s = np.exp(log_scale.astype(np.float64))
    mean = mean.astype(np.float64)
    half = bin_size / 2
    cdf_plus = sps.logistic.cdf(x + half, loc=mean, scale=s)
    cdf_minus = sps.logistic.cdf(x - half, loc=mean, scale=s)
    # above the mean both CDFs saturate at 1 in f64; the survival
    # function keeps the precision there
    sf_diff = (sps.logistic.sf(x - half, loc=mean, scale=s)
               - sps.logistic.sf(x + half, loc=mean, scale=s))
    interior = np.where(x > mean, sf_diff, cdf_plus - cdf_minus)
    p = np.where(x <= low + half, cdf_plus,
                 np.where(x >= high - half,
                          sps.logistic.sf(x - half, loc=mean, scale=s),
                          interior))
    return np.log(p)


def test_disc_logistic_matches_scipy_interior(rng):
    levels = rng.integers(1, 255, size=256)
    x = (levels / 255.0).astype(np.float32)
    mean = rng.uniform(0, 1, size=256).astype(np.float32)
    log_scale = rng.uniform(-5, 0, size=256).astype(np.float32)
    got = D.discretized_logistic_logpmf(_t(x), _t(mean), _t(log_scale))
    np.testing.assert_allclose(got.numpy(),
                               _scipy_disc_logistic(x, mean, log_scale),
                               rtol=1e-4, atol=1e-4)


def test_disc_logistic_edge_bins():
    # pixel values 0 and 255 must integrate the tails
    x = np.array([0.0, 1.0, 0.0, 1.0], np.float32)
    mean = np.array([0.1, 0.9, 0.9, 0.1], np.float32)
    log_scale = np.array([-2.0, -2.0, -3.0, -3.0], np.float32)
    got = D.discretized_logistic_logpmf(_t(x), _t(mean), _t(log_scale))
    np.testing.assert_allclose(got.numpy(),
                               _scipy_disc_logistic(x, mean, log_scale),
                               rtol=1e-4, atol=1e-4)


def test_disc_logistic_tiny_scale_far_tail_finite():
    # tiny scale, x far from the mean: the classic underflow case
    x = np.array([100 / 255.0, 5 / 255.0, 250 / 255.0], np.float32)
    mean = np.array([0.9, 0.1, 0.2], np.float32)
    log_scale = np.array([-10.0, -12.0, -14.0], np.float32)
    out = D.discretized_logistic_logpmf(_t(x), _t(mean),
                                        _t(log_scale)).numpy()
    assert np.all(np.isfinite(out))
    # f64 log-space golden from scipy's logcdf/logsf, a formulation
    # independent of the expm1 identity
    s = np.exp(log_scale.astype(np.float64))
    xa, ma = x.astype(np.float64), mean.astype(np.float64)
    half = 1 / 510.0
    lc_p = sps.logistic.logcdf(xa + half, loc=ma, scale=s)
    lc_m = sps.logistic.logcdf(xa - half, loc=ma, scale=s)
    lsf_p = sps.logistic.logsf(xa + half, loc=ma, scale=s)
    lsf_m = sps.logistic.logsf(xa - half, loc=ma, scale=s)
    want = np.where(xa <= ma,
                    lc_p + np.log1p(-np.exp(lc_m - lc_p)),
                    lsf_m + np.log1p(-np.exp(lsf_p - lsf_m)))
    np.testing.assert_allclose(out, want, rtol=1e-3)


def test_disc_logistic_sums_to_one():
    levels = torch.arange(256, dtype=torch.float32) / 255.0
    for mu, ls in [(0.5, -2.0), (0.0, -4.0), (1.0, -1.0), (0.3, -6.0)]:
        lp = D.discretized_logistic_logpmf(levels, torch.full((256,), mu),
                                           torch.full((256,), ls))
        np.testing.assert_allclose(float(torch.exp(lp).sum()), 1.0,
                                   rtol=1e-4)


def test_disc_logistic_grads_finite():
    x = torch.arange(256, dtype=torch.float32) / 255.0
    for ls in (-1.0, -7.0, -12.0):
        mean = torch.tensor(0.4, requires_grad=True)
        log_scale = torch.tensor(ls, requires_grad=True)
        loss = -torch.sum(D.discretized_logistic_logpmf(
            x, mean.expand(x.shape), log_scale.expand(x.shape)))
        g = torch.autograd.grad(loss, (mean, log_scale))
        assert all(np.isfinite(float(gi)) for gi in g), f"nan grad at ls={ls}"


def test_disc_logistic_sample_in_range():
    s = D.discretized_logistic_sample(
        torch.full((1000,), 0.5), torch.full((1000,), -2.0),
        generator=torch.Generator().manual_seed(0))
    assert float(s.min()) >= 0.0 and float(s.max()) <= 1.0
