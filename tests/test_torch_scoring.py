"""The port's scoring path as a whole against ``apv_tpu``: the per-sample
ELBO scorer, IWAE-k and the log-partition estimate.

Both sides run float32 models with the same (converted) weights, and the
port is handed the noise JAX draws (``eps=``, accepted for CPU tensors
only), so the two compute the same estimate from the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apv_tpu.eval.iwae_eval import make_iwae_fn as jax_make_iwae_fn
from apv_tpu.models.conv_vae import ConvVAE as FlaxConvVAE
from apv_tpu.models.discriminator import LatentDiscriminator as FlaxD
from apv_tpu.models.resnet_vae import ResNetVAE as FlaxVAE
from apv_tpu.ops import dispatch as jdispatch
from apv_tpu.training.losses import elbo_terms as jax_elbo_terms
from apv_tpu_torch import evaluate_nll, make_scorer
from apv_tpu_torch.convert import d_params_from_flax, params_from_flax
from apv_tpu_torch.eval.iwae_eval import (estimate_log_partition,
                                          make_iwae_fn)
from apv_tpu_torch.models import (ConvVAE, LatentDiscriminator, ResNetVAE,
                                  build_model)
from apv_tpu_torch.utils.config import apply_overrides, get_preset

torch.set_num_threads(1)

Z, B, K, CHUNK = 8, 8, 20, 10
LOG_Z = 0.37
ARCH = dict(z_dim=Z, widths=(8, 16), blocks_per_stage=1,
            image_shape=(32, 32, 3), upsample="conv_transpose",
            activation="silu", norm="rms")


def _tiny_cfg(preset="cifar_advprior_resnet"):
    return apply_overrides(get_preset(preset), [
        f"model.z_dim={Z}", "model.widths=[8,16]", "model.blocks_per_stage=1",
        "adversarial.d_widths=[32,32]", f"eval.iwae_k={K}",
        f"eval.iwae_chunk={CHUNK}", f"eval.batch_size={B}"])


@pytest.fixture(scope="module")
def pair():
    """(flax model, params, flax D, d_params, torch model, torch D, x_u8)."""
    rng = np.random.default_rng(21)
    x_u8 = rng.integers(0, 256, size=(B, 32, 32, 3), dtype=np.uint8)
    fmodel = FlaxVAE(dtype=jnp.float32, **ARCH)
    params = fmodel.init(jax.random.PRNGKey(0),
                         np.zeros((1, 32, 32, 3), np.float32),
                         np.zeros((1, Z), np.float32))["params"]
    fd = FlaxD((32, 32))
    d_params = fd.init(jax.random.PRNGKey(1), np.zeros((1, Z), np.float32))[
        "params"]
    np_tree = lambda t: jax.tree.map(np.asarray, t)        # noqa: E731
    tmodel = ResNetVAE(dtype=torch.float32, **ARCH)
    tmodel.load_state_dict(params_from_flax(np_tree(params)))
    td = LatentDiscriminator(Z, (32, 32))
    td.load_state_dict(d_params_from_flax(np_tree(d_params)))
    return fmodel, params, fd, d_params, tmodel, td, x_u8


def _levels(x_u8):
    return (x_u8.astype(np.float32) / 255.0)


def test_scorer_matches_jax_elbo_terms(pair):
    fmodel, params, fd, d_params, tmodel, td, x_u8 = pair
    x = _levels(x_u8)
    key = jax.random.PRNGKey(3)

    def encode(p, xx):
        return fmodel.apply({"params": p}, xx, method="encode")

    def decode(p, zz):
        return fmodel.apply({"params": p}, zz, method="decode")

    with jdispatch.backend("jnp"):
        recon, kl, z = jax_elbo_terms(encode, decode, params, x * 2.0 - 1.0,
                                      x, key, "discretized_logistic")
    want = np.asarray(recon - kl + fd.apply({"params": d_params}, z) - LOG_Z)
    eps = np.array(jax.random.normal(key, (B, Z), jnp.float32))

    scorer = make_scorer(_tiny_cfg(), tmodel, td, LOG_Z, device="cpu")
    got = scorer(torch.from_numpy(x), eps=torch.from_numpy(eps)).numpy()
    assert got.shape == (B,) and np.all(np.isfinite(got))
    # |ELBO| ~ 1e4 nats from 3072-term f32 sums over two f32 conv stacks
    # that agree to ~1e-5 relative: 2e-5 relative.
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-2)


def _jax_chunk_eps(key):
    """The noise JAX's IWAE draws: one split key per chunk."""
    keys = jax.random.split(key, K // CHUNK)
    return np.stack([np.asarray(jax.random.normal(k, (CHUNK, B, Z),
                                                  jnp.float32))
                     for k in keys])


def test_iwae_matches_jax_make_iwae_fn(pair):
    fmodel, params, fd, d_params, tmodel, td, x_u8 = pair
    x = _levels(x_u8)
    key = jax.random.PRNGKey(4)
    jfn = jax_make_iwae_fn(fmodel, "discretized_logistic", K, CHUNK,
                           d_apply=lambda dp, z: fd.apply({"params": dp}, z))
    with jdispatch.backend("jnp"):
        want = np.asarray(jfn(params, d_params, x * 2.0 - 1.0, x, key, LOG_Z))

    fn = make_iwae_fn(tmodel, "discretized_logistic", K, CHUNK, d_apply=td)
    with torch.no_grad():
        got = fn(torch.from_numpy(x * 2.0 - 1.0), torch.from_numpy(x), LOG_Z,
                 eps=torch.from_numpy(_jax_chunk_eps(key))).numpy()
    assert got.shape == (B,) and np.all(np.isfinite(got))
    # as the scorer, plus a logsumexp over 20 weights
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-2)


def test_iwae_chunk_invariance(pair):
    """Chunking is exact: the same 20 draws in chunks of 10 or 5."""
    *_, tmodel, td, x_u8 = pair
    x = torch.from_numpy(_levels(x_u8))
    eps = torch.from_numpy(np.random.default_rng(5).normal(
        size=(K, B, Z)).astype(np.float32))
    with torch.no_grad():
        a = make_iwae_fn(tmodel, "discretized_logistic", K, 10, td)(
            x * 2 - 1, x, eps=eps.reshape(2, 10, B, Z))
        b = make_iwae_fn(tmodel, "discretized_logistic", K, 5, td)(
            x * 2 - 1, x, eps=eps.reshape(4, 5, B, Z))
    # float32 rescaling of the running sum: a few ulps of |log w| ~ 1e4
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-2)


def test_log_partition_closed_form():
    """D(z) = a·z under N(0, I) gives log Z = ‖a‖²/2."""
    a = torch.linspace(0.1, 0.4, Z)
    log_z, se = estimate_log_partition(lambda z: z @ a, Z, seed=3,
                                       with_se=True, device="cpu")
    exact = float(a.square().sum() / 2)
    assert 0 < float(se) < 0.02
    # MC error: Var(e^{a·z})/E² = e^{‖a‖²} - 1, i.e. a relative SE ~ 0.003
    # at n = 1e5; bar at 5 jackknife SEs.
    assert abs(float(log_z) - exact) < 5 * float(se)
    assert abs(float(estimate_log_partition(lambda z: z @ a, Z, seed=3,
                                            device="cpu")) - float(log_z)) \
        < 1e-6


def test_evaluate_nll_end_to_end_on_cpu():
    """The config-4 entry point at tiny size: keys, finiteness, bits/dim
    consistency, and the IWAE bound above the ELBO on the same images."""
    cfg = _tiny_cfg("iwae_eval")
    model = build_model(cfg.model, device="cpu", dtype=torch.float32)
    from apv_tpu_torch.models import make_latent_d
    d = make_latent_d(cfg.adversarial, cfg.model.z_dim, device="cpu")
    x_u8 = np.random.default_rng(6).integers(0, 256, (2 * B, 32, 32, 3),
                                              dtype=np.uint8)
    res = evaluate_nll(cfg, model, d, x_u8, seed=1, per_sample=True,
                       device="cpu")
    for key in ("nll_nats", "nll_nats_se", "bits_per_dim", "iwae_k",
                "num_examples", "log_partition", "log_partition_se",
                "adversarial_prior", "prior", "per_sample"):
        assert key in res
    assert res["num_examples"] == 2 * B and res["iwae_k"] == K
    assert np.isfinite(res["bits_per_dim"]) and res["log_partition_se"] > 0
    np.testing.assert_allclose(res["bits_per_dim"],
                               res["nll_nats"] / (3072 * np.log(2.0)))
    scorer = make_scorer(cfg, model, d, res["log_partition"], device="cpu")
    x = torch.from_numpy(_levels(x_u8))
    elbo = scorer(x, generator=torch.Generator().manual_seed(2)).numpy()
    # IWAE-20 ≥ ELBO in expectation per image; compare the means with the
    # ELBO's spread over images as the margin.
    margin = elbo.std(ddof=1) / np.sqrt(len(elbo))
    assert res["per_sample"].mean() >= elbo.mean() - margin


# -- the MNIST family: conv VAE, Bernoulli likelihood, binarized input ------

MNIST_ARCH = dict(z_dim=Z, widths=(8, 16), dense=32, image_shape=(28, 28, 1))


@pytest.fixture(scope="module")
def mnist_pair():
    """(flax conv VAE, params, flax D, d_params, torch model, torch D,
    binarized images [B, 28, 28, 1] f32)."""
    rng = np.random.default_rng(22)
    x = (rng.random((B, 28, 28, 1)) < 0.3).astype(np.float32)
    fmodel = FlaxConvVAE(dtype=jnp.float32, **MNIST_ARCH)
    params = fmodel.init(jax.random.PRNGKey(5), x,
                         np.zeros((1, Z), np.float32))["params"]
    fd = FlaxD((32, 32))
    d_params = fd.init(jax.random.PRNGKey(6), np.zeros((1, Z), np.float32))[
        "params"]
    np_tree = lambda t: jax.tree.map(np.asarray, t)        # noqa: E731
    tmodel = ConvVAE(dtype=torch.float32, **MNIST_ARCH)
    tmodel.load_state_dict(params_from_flax(np_tree(params)))
    td = LatentDiscriminator(Z, (32, 32))
    td.load_state_dict(d_params_from_flax(np_tree(d_params)))
    return fmodel, params, fd, d_params, tmodel, td, x


def _mnist_cfg():
    return apply_overrides(get_preset("mnist_advprior"), [
        f"model.z_dim={Z}", "model.widths=[8,16]", "model.dense=32",
        "adversarial.d_widths=[32,32]", f"eval.iwae_k={K}",
        f"eval.iwae_chunk={CHUNK}", f"eval.batch_size={B}"])


def test_mnist_scorer_matches_jax_elbo_terms(mnist_pair):
    """Binarized configs feed x straight through: the encoder sees {0,1}
    and the Bernoulli likelihood scores it."""
    fmodel, params, fd, d_params, tmodel, td, x = mnist_pair
    key = jax.random.PRNGKey(7)

    def encode(p, xx):
        return fmodel.apply({"params": p}, xx, method="encode")

    def decode(p, zz):
        return fmodel.apply({"params": p}, zz, method="decode")

    with jdispatch.backend("jnp"):
        recon, kl, z = jax_elbo_terms(encode, decode, params, x, x, key,
                                      "bernoulli")
    want = np.asarray(recon - kl + fd.apply({"params": d_params}, z) - LOG_Z)
    eps = np.array(jax.random.normal(key, (B, Z), jnp.float32))
    scorer = make_scorer(_mnist_cfg(), tmodel, td, LOG_Z, device="cpu")
    got = scorer(torch.from_numpy(x), eps=torch.from_numpy(eps)).numpy()
    assert got.shape == (B,) and np.all(np.isfinite(got))
    # |ELBO| ~ 550 nats from 784-term f32 sums over two f32 conv stacks:
    # 2e-5 relative, as the CIFAR scorer
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-2)


def test_mnist_iwae_matches_jax_make_iwae_fn(mnist_pair):
    fmodel, params, fd, d_params, tmodel, td, x = mnist_pair
    key = jax.random.PRNGKey(8)
    jfn = jax_make_iwae_fn(fmodel, "bernoulli", K, CHUNK,
                           d_apply=lambda dp, z: fd.apply({"params": dp}, z))
    with jdispatch.backend("jnp"):
        want = np.asarray(jfn(params, d_params, x, x, key, LOG_Z))
    fn = make_iwae_fn(tmodel, "bernoulli", K, CHUNK, d_apply=td)
    with torch.no_grad():
        got = fn(torch.from_numpy(x), torch.from_numpy(x), LOG_Z,
                 eps=torch.from_numpy(_jax_chunk_eps(key))).numpy()
    assert got.shape == (B,) and np.all(np.isfinite(got))
    # as the scorer, plus a logsumexp over 20 weights
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-2)


def test_mnist_evaluate_nll_end_to_end_on_cpu():
    """Config 2 at tiny size through the entry point: bits/dim over 784
    dims, and the IWAE bound above the ELBO on the same binarized images."""
    cfg = _mnist_cfg()
    model = build_model(cfg.model, device="cpu", dtype=torch.float32)
    from apv_tpu_torch.models import make_latent_d
    d = make_latent_d(cfg.adversarial, cfg.model.z_dim, device="cpu")
    bits = (np.random.default_rng(9).random((2 * B, 28, 28, 1)) < 0.3)
    res = evaluate_nll(cfg, model, d, bits.astype(np.uint8), seed=1,
                       per_sample=True, device="cpu")
    assert res["num_examples"] == 2 * B and res["iwae_k"] == K
    np.testing.assert_allclose(res["bits_per_dim"],
                               res["nll_nats"] / (784 * np.log(2.0)))
    scorer = make_scorer(cfg, model, d, res["log_partition"], device="cpu")
    elbo = scorer(torch.from_numpy(bits.astype(np.float32)),
                  generator=torch.Generator().manual_seed(2)).numpy()
    margin = elbo.std(ddof=1) / np.sqrt(len(elbo))
    assert res["per_sample"].mean() >= elbo.mean() - margin
