"""The port's sampling module against ``apv_tpu.sampling.run``.

JAX and torch draw different random numbers, so each test replays the JAX
function's own key splits to reproduce its draws (the SIR pool and pick,
MALA's proposals and accept uniforms, the GMM's first point, the posterior
and ex-post draws, the pixel noise) and hands them to the port's injection
hooks. Both sides then compute the same thing from the same draws, on a
tiny f32 ResNet VAE and latent D carried across by ``convert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apv_tpu.models.discriminator import LatentDiscriminator as FlaxD
from apv_tpu.models.discriminator import d_apply_fn
from apv_tpu.models.resnet_vae import ResNetVAE as FlaxVAE
from apv_tpu.sampling import run as jrun
from apv_tpu_torch.convert import d_params_from_flax, params_from_flax
from apv_tpu_torch.models import LatentDiscriminator, ResNetVAE
from apv_tpu_torch.sampling import run as trun

torch.set_num_threads(1)

Z = 8
ARCH = dict(z_dim=Z, widths=(8, 16), blocks_per_stage=1,
            image_shape=(32, 32, 3), upsample="conv_transpose",
            activation="silu", norm="rms")
LIK = "discretized_logistic"


def _np(a):
    return np.array(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def pair():
    """(flax VAE, params, flax D apply, d_params, torch VAE, torch D)."""
    fmodel = FlaxVAE(dtype=jnp.float32, **ARCH)
    params = jax.jit(fmodel.init)(jax.random.PRNGKey(0),
                                  np.zeros((1, 32, 32, 3), np.float32),
                                  np.zeros((1, Z), np.float32))["params"]
    fd = FlaxD((32, 32))
    d_params = jax.jit(fd.init)(jax.random.PRNGKey(1),
                                np.zeros((1, Z), np.float32))["params"]
    # a sharper D than its init, so SIR weights and MALA moves are not flat
    d_params = jax.tree.map(lambda a: a * 3.0, d_params)
    tree = lambda t: jax.tree.map(np.asarray, t)        # noqa: E731
    tmodel = ResNetVAE(dtype=torch.float32, **ARCH)
    tmodel.load_state_dict(params_from_flax(tree(params)))
    td = LatentDiscriminator(Z, (32, 32))
    td.load_state_dict(d_params_from_flax(tree(d_params)))
    return fmodel, params, d_apply_fn(fd), d_params, tmodel.eval(), td


def _sir_draws(key, n, pool_factor, d_apply, d_params):
    """sample_prior's draws: pool, logw, pick, and the MALA key."""
    k_pool, k_sel, k_mala = jax.random.split(key, 3)
    pool = jax.random.normal(k_pool, (n * pool_factor, Z), jnp.float32)
    logw = d_apply(d_params, pool)
    pick = jax.random.categorical(k_sel, logw, shape=(n,))
    return pool, logw, pick, k_mala


def _mala_draws(key, steps, n):
    """langevin_refine's per-step proposal normals and accept uniforms."""
    noise, unif = [], []
    for _ in range(steps):
        key, k_prop, k_acc = jax.random.split(key, 3)
        noise.append(jax.random.normal(k_prop, (n, Z), jnp.float32))
        unif.append(jax.random.uniform(k_acc, (n,), jnp.float32))
    return jnp.stack(noise), jnp.stack(unif)


def test_sir_ess_matches(rng):
    logw = rng.normal(size=500).astype(np.float32) * 3
    assert _rel(trun.sir_ess(_t(logw)), jrun.sir_ess(jnp.asarray(logw))) \
        <= 1e-5
    assert float(trun.sir_ess(torch.zeros(64))) == pytest.approx(64.0)


def test_sample_prior_sir_replays_jax(pair):
    """pool, logw, ESS and the picked z from the same draws."""
    _, _, d_apply, d_params, _, td = pair
    key, n = jax.random.PRNGKey(4), 32
    want, diag = jrun.sample_prior(key, n, Z, d_apply=d_apply,
                                   d_params=d_params,
                                   return_diagnostics=True)
    pool, logw, pick, _ = _sir_draws(key, n, 16, d_apply, d_params)
    with torch.no_grad():
        got, tdiag = trun.sample_prior(n, Z, d=td, return_diagnostics=True,
                                       pool=_t(pool), pick=_t(pick))
        assert _rel(td(_t(pool)), logw) <= 1e-5
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-6)
    assert _rel(tdiag["sir_ess"], diag["sir_ess"]) <= 1e-5
    assert tdiag["sir_pool"] == diag["sir_pool"] == n * 16


def test_langevin_refine_replays_jax(pair):
    """z, the acceptance rate and the adapted step size after MALA from
    the same SIR draws, proposals and accept uniforms: 1e-5 relative."""
    _, _, d_apply, d_params, _, td = pair
    key, n, steps = jax.random.PRNGKey(5), 32, 6
    want, diag = jrun.sample_prior(key, n, Z, d_apply=d_apply,
                                   d_params=d_params, refine_steps=steps,
                                   return_diagnostics=True)
    pool, _, pick, k_mala = _sir_draws(key, n, 16, d_apply, d_params)
    noise, unif = _mala_draws(k_mala, steps, n)
    got, tdiag = trun.sample_prior(n, Z, d=td, refine_steps=steps,
                                   return_diagnostics=True, pool=_t(pool),
                                   pick=_t(pick), mala_noise=_t(noise),
                                   mala_uniforms=_t(unif))
    assert _rel(got.numpy(), want) <= 1e-5
    assert abs(float(tdiag["mala_accept_rate"])
               - float(diag["mala_accept_rate"])) <= 1e-5
    assert _rel(tdiag["mala_step_size"], diag["mala_step_size"]) <= 1e-5
    assert 0.0 < float(tdiag["mala_accept_rate"]) <= 1.0
    # the same chains through langevin_refine directly
    z0 = _t(pool)[_t(pick).long()]
    z, rate, eps = trun.langevin_refine(
        z0, lambda zz: trun.shaped_prior_logp(zz, td), steps,
        noise=_t(noise), uniforms=_t(unif))
    assert torch.equal(z, got) and float(rate) == float(
        tdiag["mala_accept_rate"])


def test_fit_gmm_em_from_same_init(rng):
    """Three separated clusters: log-weights, means and variances from the
    same first point agree within 1e-4."""
    centers = np.array([[-4.0] * Z, [0.0] * Z, [4.0] * Z], np.float32)
    z = (centers[rng.integers(0, 3, 600)]
         + rng.normal(size=(600, Z)) * np.linspace(0.3, 1.0, Z)).astype(
        np.float32)
    key = jax.random.PRNGKey(6)
    want = jrun.fit_gmm_em(key, jnp.asarray(z), 3, iters=40)
    first = int(jax.random.randint(key, (), 0, len(z)))
    got = trun.fit_gmm_em(_t(z), 3, iters=40, first=first)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(w), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="cannot fit"):
        trun.fit_gmm_em(_t(z[:2]), 3)


def _x_in(rng, n=16):
    return (rng.random((n, 32, 32, 3)) * 2 - 1).astype(np.float32)


def test_expost_moments_and_gmm(rng, pair):
    """expost_prior_moments; expost_prior_gmm from the same posterior
    draws and first point; expost_prior_flow from the same posterior draws
    and fit draws; expost_prior_sample and expost_prior_logpdf for all
    three forms."""
    fmodel, params, _, _, tmodel, _ = pair
    x = _x_in(rng)
    want_m = jrun.expost_prior_moments(fmodel, params, jnp.asarray(x))
    got_m = trun.expost_prior_moments(tmodel, _t(x))
    for a, w in zip(got_m, want_m):
        assert _rel(a.numpy(), w) <= 1e-5

    key, k, draws = jax.random.PRNGKey(7), 3, 2
    want_g = jrun.expost_prior_gmm(fmodel, params, jnp.asarray(x), key, k=k,
                                   iters=20, draws_per_x=draws)
    k_draw, k_fit = jax.random.split(key)
    eps = jnp.stack([jax.random.normal(kk, (len(x), Z), jnp.float32)
                     for kk in jax.random.split(k_draw, draws)])
    n_pts = draws * len(x)
    first = int(jax.random.randint(k_fit, (), 0, n_pts))
    got_g = trun.expost_prior_gmm(tmodel, _t(x), k=k, iters=20,
                                  draws_per_x=draws, eps=_t(eps), first=first)
    for a, w in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), _np(w), rtol=1e-4, atol=1e-4)

    n = 24
    for pm_j, pm_t in ((want_m, got_m), (want_g, got_g)):
        ks = jax.random.PRNGKey(8)
        want_s = jrun.expost_prior_sample(ks, pm_j, n, Z)
        if len(pm_j) == 2:
            inj = {"eps": _t(jax.random.normal(ks, (n, Z), jnp.float32))}
        else:
            k_c, k_e = jax.random.split(ks)
            inj = {"ids": _t(jax.random.categorical(k_c, pm_j[0], shape=(n,))),
                   "eps": _t(jax.random.normal(k_e, (n, Z), jnp.float32))}
        got_s = trun.expost_prior_sample(pm_t, n, Z, **inj)
        np.testing.assert_allclose(got_s.numpy(), _np(want_s), rtol=1e-4,
                                   atol=1e-4)
        zq = rng.normal(size=(5, Z)).astype(np.float32)
        np.testing.assert_allclose(
            trun.expost_prior_logpdf(pm_t)(_t(zq)).numpy(),
            _np(jrun.expost_prior_logpdf(pm_j)(jnp.asarray(zq))),
            rtol=1e-5, atol=1e-4)

    # the flow form: a 10-step fit of a 2-layer flow on 4 draws per image,
    # JAX's posterior draws, shuffle, init draws and minibatch rows
    # injected (core/flow.fit_flow); f32 gradients through 10 AdamW steps
    key, draws, steps, hidden = jax.random.PRNGKey(9), 4, 10, 8
    want_f = jrun.expost_prior_flow(fmodel, params, jnp.asarray(x), key,
                                    n_layers=2, hidden=hidden, steps=steps)
    k_draw, k_fit = jax.random.split(key)
    eps = jnp.stack([jax.random.normal(kk, (len(x), Z), jnp.float32)
                     for kk in jax.random.split(k_draw, draws)])
    k_init, k_perm, k_idx = jax.random.split(k_fit, 3)
    n_pts = draws * len(x)
    n_train = n_pts - int(n_pts * 0.1)
    init, kk = [], k_init
    for _ in range(2):
        kk, k1, k2 = jax.random.split(kk, 3)
        init.append((_np(jax.random.normal(k1, (Z, hidden))),
                     _np(jax.random.normal(k2, (hidden, hidden)))))
    fit_draws = {
        "perm": torch.from_numpy(_np(jax.random.permutation(k_perm, n_pts))),
        "init_draws": init,
        "indices": torch.from_numpy(np.stack([
            _np(jax.random.randint(ki, (n_train,), 0, n_train))
            for ki in jax.random.split(k_idx, steps)]))}
    got_f = trun.expost_prior_flow(tmodel, _t(x), n_layers=2, hidden=hidden,
                                   steps=steps, eps=_t(eps),
                                   fit_draws=fit_draws)
    np.testing.assert_allclose(float(got_f["flow_nll"]),
                               float(want_f["flow_nll"]), rtol=1e-4)
    ks = jax.random.PRNGKey(10)
    want_s = jrun.expost_prior_sample(ks, want_f, 24, Z)
    got_s = trun.expost_prior_sample(
        got_f, 24, Z, eps=_t(jax.random.normal(ks, (24, Z), jnp.float32)))
    np.testing.assert_allclose(got_s.numpy(), _np(want_s), rtol=1e-3,
                               atol=1e-3)
    zq = rng.normal(size=(5, Z)).astype(np.float32)
    np.testing.assert_allclose(
        trun.expost_prior_logpdf(got_f)(_t(zq)).numpy(),
        _np(jrun.expost_prior_logpdf(want_f)(jnp.asarray(zq))),
        rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("likelihood,chans", [("discretized_logistic", 6),
                                              ("bernoulli", 1)])
def test_decoder_pixels_both_modes(rng, likelihood, chans):
    """'mean' and, with JAX's uniforms injected, 'sample'."""
    out = (rng.normal(size=(4, 8, 8, chans)) * 0.6).astype(np.float32)
    if likelihood == "discretized_logistic":
        out[..., :3] += 0.5
    c = chans // 2 if likelihood == "discretized_logistic" else chans
    key = jax.random.PRNGKey(9)
    for mode in ("mean", "sample"):
        want = _np(jrun.decoder_pixels(jnp.asarray(out), key, likelihood, c,
                                       mode))
        u = None
        if mode == "sample":
            shape = (4, 8, 8, c)
            u = (jax.random.uniform(key, shape, minval=1e-5,
                                    maxval=1.0 - 1e-5)
                 if likelihood == "discretized_logistic"
                 else jax.random.uniform(key, shape))
            u = _t(u)
        got = trun.decoder_pixels(_t(out), likelihood, c, mode, u=u).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="pixel mode"):
        trun.decoder_pixels(_t(out), likelihood, c, "median")


def test_generate_samples_end_to_end(pair):
    """SIR + 4 MALA steps + decode + pixel sampling on a tiny flagship,
    all of JAX's draws replayed (images to a bin, 1/255, since a z one
    ulp apart may round to the next level; the diagnostics 1e-5)."""
    fmodel, params, d_apply, d_params, tmodel, td = pair
    key, n, steps = jax.random.PRNGKey(10), 16, 4
    want, diag = jrun.generate_samples(
        fmodel, params, key, n, Z, LIK, 3, d_apply=d_apply,
        d_params=d_params, mode="sample", refine_steps=steps,
        return_diagnostics=True)
    k_z, k_x = jax.random.split(key)
    pool, _, pick, k_mala = _sir_draws(k_z, n, 16, d_apply, d_params)
    noise, unif = _mala_draws(k_mala, steps, n)
    pixel_u = jax.random.uniform(k_x, (n, 32, 32, 3), minval=1e-5,
                                 maxval=1.0 - 1e-5)
    got, tdiag = trun.generate_samples(
        tmodel, n, Z, LIK, 3, d=td, mode="sample", refine_steps=steps,
        return_diagnostics=True,
        draws={"pool": _t(pool), "pick": _t(pick), "mala_noise": _t(noise),
               "mala_uniforms": _t(unif), "pixel_u": _t(pixel_u)})
    assert got.shape == (n, 32, 32, 3)
    assert np.abs(got.numpy() - _np(want)).max() <= 1.0 / 255 + 1e-6
    assert np.mean(np.abs(got.numpy() - _np(want)) > 1e-6) < 1e-3
    for name in ("sir_ess", "mala_accept_rate", "mala_step_size"):
        assert _rel(tdiag[name], diag[name]) <= 1e-5, name
    assert tdiag["sir_pool"] == diag["sir_pool"]
    assert tdiag["mala_steps"] == diag["mala_steps"] == steps


def test_generate_samples_seeded_and_shapes(pair):
    _, _, _, _, tmodel, td = pair
    a = trun.generate_samples(tmodel, 4, Z, LIK, 3, d=td, seed=3,
                              mode="sample")
    b = trun.generate_samples(tmodel, 4, Z, LIK, 3, d=td, seed=3,
                              mode="sample")
    c = trun.generate_samples(tmodel, 4, Z, LIK, 3, d=td, seed=4,
                              mode="sample")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    g1, g2 = trun.seed_generators(3, 2, "cpu")
    assert not torch.equal(torch.randn(8, generator=g1),
                           torch.randn(8, generator=g2))


def test_generate_samples_refusals(pair):
    """The reference's argument checks, in its order; then the trained
    prior's draws, which on a standard-prior model are the N(0, I) draws
    themselves (its prior_sample_from is the identity)."""
    _, _, _, _, tmodel, td = pair
    pm = (torch.zeros(Z), torch.ones(Z))

    def gen(**kw):
        return trun.generate_samples(tmodel, 2, Z, LIK, 3, **kw)

    with pytest.raises(ValueError, match="ex-post prior is sampled"):
        gen(prior_moments=pm, refine_steps=2, d=td)
    with pytest.raises(ValueError, match="model_prior"):
        gen(model_prior=True, d=td)
    with pytest.raises(ValueError, match="model_base"):
        gen(model_base=True, prior_moments=pm)
    with pytest.raises(ValueError, match="temperature"):
        gen(temperature=0.8)
    pool = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, Z)).astype(np.float32))
    assert torch.equal(gen(model_prior=True, draws={"pool": pool}),
                       gen(draws={"pool": pool}))
    assert gen(model_base=True, d=td, temperature=0.9).shape == (2, 32, 32,
                                                                 3)
    with pytest.raises(ValueError, match="no latent"):
        trun.sample_prior(4, Z, refine_steps=2)
    with pytest.raises(ValueError, match="steps >= 1"):
        trun.langevin_refine(torch.zeros(2, Z), lambda z: z.sum(-1), 0)
    with pytest.raises(ValueError, match="injected pool"):
        trun.sample_prior(4, Z, d=td, pool=torch.zeros(5, Z))


def test_reconstruct_and_interpolate(rng, pair):
    """reconstruct_images with JAX's posterior draw; latent_interpolate
    (deterministic) for slerp and lerp."""
    fmodel, params, _, _, tmodel, _ = pair
    x = _x_in(rng, 4)
    key = jax.random.PRNGKey(11)
    want = jrun.reconstruct_images(fmodel, params, jnp.asarray(x), key, LIK,
                                   3)
    k_z, _ = jax.random.split(key)
    eps = jax.random.normal(k_z, (len(x), Z), jnp.float32)
    got = trun.reconstruct_images(tmodel, _t(x), LIK, 3, eps=_t(eps))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)
    want = jrun.latent_interpolate(fmodel, params, jnp.asarray(x[:2]),
                                   jnp.asarray(x[2:]), 5, LIK, 3)
    got = trun.latent_interpolate(tmodel, _t(x[:2]), _t(x[2:]), 5, LIK, 3)
    assert got.shape == (2, 5, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)
    # lerp's ends are the decoded posterior means, as slerp's are
    lerp = trun.latent_interpolate(tmodel, _t(x[:2]), _t(x[2:]), 5, LIK, 3,
                                   kind="lerp")
    np.testing.assert_allclose(lerp[:, [0, -1]].numpy(),
                               got[:, [0, -1]].numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="interpolation kind"):
        trun.latent_interpolate(tmodel, _t(x[:2]), _t(x[2:]), 3, LIK, 3,
                                kind="spline")


@pytest.mark.parametrize("c", [3, 1])
def test_save_image_grid_writes_pillows_bytes(rng, tmp_path, c):
    """The port's grid (its own PNG encoder) is byte for byte the file the
    reference writes through Pillow, and decodes to the grid's pixels."""
    from apv_tpu_torch.utils.png import decode_png
    images = rng.random((10, 6, 5, c)).astype(np.float32)
    images[0, 0, 0] = 1.5                            # clipped
    a = trun.save_image_grid(_t(images), tmp_path / "port" / "g.png",
                             cols=4)
    b = jrun.save_image_grid(jnp.asarray(images), tmp_path / "ref.png",
                             cols=4)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(decode_png(a.read_bytes()),
                                  trun.image_grid(images, cols=4))
