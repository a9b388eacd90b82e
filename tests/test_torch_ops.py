"""The port's fused ops (``apv_tpu_torch.ops``) against ``apv_tpu``.

On the CPU the ops run their plain PyTorch versions; these tests hold them
to the jnp tier (``apv_tpu.ops.dispatch``) and to the Pallas kernels in
interpret mode (``apv_tpu.ops.kernels``) on the shapes and edge cases of
``tests/test_kernels.py``. The CUDA kernels themselves are held to the same
plain versions on the card by ``chip_smoke.py``.
"""

import jax
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

def test_cuda_wrappers_refuse_grad_and_cpu_tensors():
    m = torch.zeros(4, 8, requires_grad=True)
    lv = torch.zeros(4, 8)
    with pytest.raises(RuntimeError, match="forward only"):
        K.kl_cuda(m, lv)
    with pytest.raises(RuntimeError, match="forward only"):
        K.reparam_cuda(m, lv, 2, 0, 0)
    with pytest.raises(RuntimeError, match="forward only"):
        K.disc_logistic_cuda(lv, m, lv)
    with pytest.raises(ValueError, match="plain version takes CPU"):
        K.kl_cuda(lv, lv)
    with pytest.raises(ValueError, match="all on one CUDA device"):
        ops.kl_standard(lv, torch.zeros(4, 8, device="meta"))
