"""The port's mixture of discretized logistics
(``model.likelihood=disc_logistic_mix``) against ``apv_tpu``'s.

The goldens of ``tests/test_distributions.py`` through the port's
functions; the likelihood op's values and gradients against ``jax.grad``
of the reference's, also with x broadcast over ``samples=S`` decodings
(never copied); the head's split, the pixel mean and the sampler's pixels
(JAX's component picks and uniforms injected); the IWAE estimate of a tiny
mixture ResNet VAE against ``make_iwae_fn`` on JAX's noise; three tiny
``cifar_advprior_resnet`` steps with K=3 against ``make_train_fns`` at the
other step tests' bars; and the port alone training, scoring and sampling
the head (``tests/test_train.py:630``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps
import torch
from scipy.special import logsumexp

from conftest import tiny_config
from apv_tpu.eval.iwae_eval import make_iwae_fn as jax_make_iwae_fn
from apv_tpu.models.resnet_vae import ResNetVAE as FlaxVAE
from apv_tpu.ops import dispatch as jdispatch
from apv_tpu.sampling import run as jrun
from apv_tpu.training import losses as jlosses
from apv_tpu.training import step as jstep
from apv_tpu_torch import evaluate_nll, ops
from apv_tpu_torch.convert import d_params_from_flax, params_from_flax
from apv_tpu_torch.core import distributions as D
from apv_tpu_torch.eval.iwae_eval import make_iwae_fn
from apv_tpu_torch.models import ResNetVAE
from apv_tpu_torch.sampling import run as trun
from apv_tpu_torch.training import losses as tlosses
from apv_tpu_torch.training import step as tstep
from apv_tpu_torch.utils.config import config_from_dict

torch.set_num_threads(1)

MIX = {"model.likelihood": "disc_logistic_mix", "model.mix_components": 3}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(a):
    return np.asarray(a, np.float32)


def _scipy_disc_logistic(x, mean, log_scale, bin_size=1 / 255., low=0.,
                         high=1.):
    """Direct CDF difference in float64 (tests/test_distributions.py)."""
    s = np.exp(log_scale.astype(np.float64))
    mean = mean.astype(np.float64)
    half = bin_size / 2
    cdf_plus = sps.logistic.cdf(x + half, loc=mean, scale=s)
    cdf_minus = sps.logistic.cdf(x - half, loc=mean, scale=s)
    sf_diff = (sps.logistic.sf(x - half, loc=mean, scale=s)
               - sps.logistic.sf(x + half, loc=mean, scale=s))
    interior = np.where(x > mean, sf_diff, cdf_plus - cdf_minus)
    p = np.where(x <= low + half, cdf_plus,
                 np.where(x >= high - half,
                          sps.logistic.sf(x - half, loc=mean, scale=s),
                          interior))
    return np.log(p)


# -- the goldens of tests/test_distributions.py:194-256 ------------------------

def test_disc_logistic_mix_matches_numpy_golden(rng):
    n, k = 128, 4
    x = (rng.integers(0, 256, size=n) / 255.0).astype(np.float32)
    means = rng.uniform(-0.2, 1.2, size=(n, k)).astype(np.float32)
    log_scales = rng.uniform(-6, 0, size=(n, k)).astype(np.float32)
    logits = rng.normal(size=(n, k)).astype(np.float32)
    got = D.discretized_logistic_mixture_logpmf(
        _t(x), _t(means), _t(log_scales), _t(logits)).numpy()
    comp = np.stack([_scipy_disc_logistic(x, means[:, j], log_scales[:, j])
                     for j in range(k)], axis=-1)
    lw = logits.astype(np.float64)
    lw = lw - logsumexp(lw, axis=-1, keepdims=True)
    np.testing.assert_allclose(got, logsumexp(lw + comp, axis=-1),
                               rtol=1e-4, atol=1e-4)


def test_disc_logistic_mix_k1_reduces_to_single(rng):
    x = (rng.integers(0, 256, size=64) / 255.0).astype(np.float32)
    mean = rng.uniform(0, 1, size=64).astype(np.float32)
    log_scale = rng.uniform(-6, 0, size=64).astype(np.float32)
    got = D.discretized_logistic_mixture_logpmf(
        _t(x), _t(mean[:, None]), _t(log_scale[:, None]),
        _t(np.full((64, 1), 3.7))).numpy()
    want = D.discretized_logistic_logpmf(_t(x), _t(mean),
                                         _t(log_scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_disc_logistic_mix_sums_to_one():
    levels = torch.arange(256, dtype=torch.float32) / 255.0
    lp = D.discretized_logistic_mixture_logpmf(
        levels, _t([0.2, 0.5, 0.9]).expand(256, 3),
        _t([-2.0, -5.0, -3.0]).expand(256, 3),
        _t([0.5, -1.0, 1.5]).expand(256, 3))
    np.testing.assert_allclose(float(torch.exp(lp).sum()), 1.0, rtol=1e-4)


def test_disc_logistic_mix_grads_finite():
    x = torch.arange(256, dtype=torch.float32) / 255.0
    args = [_t(v).requires_grad_(True) for v in
            ([0.1, 0.5, 0.9], [-1.0, -7.0, -12.0], [0.0, 2.0, -2.0])]
    loss = -D.discretized_logistic_mixture_logpmf(
        x, *(a.expand(256, 3) for a in args)).sum()
    for g in torch.autograd.grad(loss, args):
        assert torch.isfinite(g).all()


def test_disc_logistic_mix_sample_moments_and_mean():
    """Two sharp components with weights (0.25, 0.75): the draws sit on the
    1/255 grid in [0, 1], 3/4 of them at the upper one, and their mean is
    the mixture mean 0.65."""
    n = 4000
    means = _t([0.2, 0.8]).expand(n, 2)
    log_scales = torch.full((n, 2), -6.0)
    logits = _t([0.0, np.log(3.0)]).expand(n, 2)
    s = D.discretized_logistic_mixture_sample(
        means, log_scales, logits,
        generator=torch.Generator().manual_seed(0)).numpy()
    assert s.min() >= 0.0 and s.max() <= 1.0
    np.testing.assert_allclose(s * 255, np.round(s * 255), atol=1e-4)
    assert 0.70 < float((s > 0.5).mean()) < 0.80
    m = D.discretized_logistic_mixture_mean(means, logits).numpy()
    np.testing.assert_allclose(m, 0.65, rtol=1e-5)
    assert abs(float(s.mean()) - 0.65) < 0.02


# -- the op against jax.grad --------------------------------------------------

def _mix_inputs(rng, rows, k=3, shape=(4, 5, 3)):
    x = (rng.integers(0, 256, size=(rows,) + shape) / 255.0).astype(
        np.float32)
    means = rng.uniform(-0.2, 1.2, size=(rows,) + shape + (k,))
    log_scales = rng.uniform(-8, 0, size=(rows,) + shape + (k,))
    logits = rng.normal(size=(rows,) + shape + (k,))
    return x, *(a.astype(np.float32) for a in (means, log_scales, logits))


def test_mix_recon_ll_values_and_gradients_match_jax(rng):
    """Per-row sums and their gradients in the three parameter tensors
    against the reference op and ``jax.grad``, at 1e-5 relative (log
    scales down to −8, below the head's floor of −7, reach the small-t
    branch)."""
    x, *params = _mix_inputs(rng, 6)
    w = rng.normal(size=6).astype(np.float32)

    def j_loss(*p):
        return jnp.sum(w * jdispatch.disc_logistic_mix_recon_ll(x, *p))

    want = np.asarray(jdispatch.disc_logistic_mix_recon_ll(x, *params))
    want_g = jax.grad(j_loss, argnums=(0, 1, 2))(*params)
    tp = [_t(p).requires_grad_(True) for p in params]
    got = ops.disc_logistic_mix_recon_ll(_t(x), *tp)
    got_g = torch.autograd.grad((got * _t(w)).sum(), tp)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    for g, wg in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(wg).max()))


def test_mix_recon_ll_broadcasts_x_without_a_copy(rng, monkeypatch):
    """With ``samples=S`` the parameters' S·B rows are scored against x's
    B rows: each equals the row scored against x expanded, and the log
    pmf receives x itself as a broadcast view, never a copy."""
    s, b = 3, 4
    x, *params = _mix_inputs(rng, s * b)
    x = x[:b]
    tx, tp = _t(x), [_t(p) for p in params]
    seen = []
    logpmf = D.discretized_logistic_mixture_logpmf

    def spy(xx, *a, **kw):
        seen.append(xx)
        return logpmf(xx, *a, **kw)

    monkeypatch.setattr(D, "discretized_logistic_mixture_logpmf", spy)
    got = ops.disc_logistic_mix_recon_ll(tx, *tp, samples=s)
    assert seen[0].shape == (1,) + tx.shape
    assert seen[0].data_ptr() == tx.data_ptr()
    want = ops.disc_logistic_mix_recon_ll(
        tx.repeat(s, 1, 1, 1), *tp)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="samples"):
        ops.disc_logistic_mix_recon_ll(tx, *tp, samples=2)


def test_head_split_pixel_mean_and_recon_match_jax(rng):
    """``decoder_output_to_likelihood_params`` keeps the reference's
    [B,H,W,C,3K] layout (means, floored log scales, logits),
    ``likelihood_pixel_mean`` is the clipped mixture mean, and
    ``recon_log_likelihood`` sums the pixels; a head of the wrong width is
    refused."""
    out = rng.normal(size=(2, 4, 4, 27)).astype(np.float32) * 3.0
    x = (rng.integers(0, 256, size=(2, 4, 4, 3)) / 255.0).astype(np.float32)
    got = tlosses.decoder_output_to_likelihood_params(
        _t(out), "disc_logistic_mix", 3)
    want = jlosses.decoder_output_to_likelihood_params(
        out, "disc_logistic_mix", 3)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 4, 4, 3, 3)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(
        tlosses.likelihood_pixel_mean(_t(out), "disc_logistic_mix",
                                      3).numpy(),
        np.asarray(jlosses.likelihood_pixel_mean(out, "disc_logistic_mix",
                                                 3)), rtol=1e-6, atol=1e-7)
    with jdispatch.backend("jnp"):
        want_r = np.asarray(jlosses.recon_log_likelihood(
            x, out, "disc_logistic_mix"))
    np.testing.assert_allclose(
        tlosses.recon_log_likelihood(_t(x), _t(out),
                                     "disc_logistic_mix").numpy(),
        want_r, rtol=1e-5)
    with pytest.raises(ValueError, match="3·K·C"):
        tlosses.decoder_output_to_likelihood_params(
            _t(out[..., :26]), "disc_logistic_mix", 3)


def test_decoder_pixels_mixture_both_modes(rng):
    """'mean' and, with JAX's component picks and uniforms injected,
    'sample' (apv_tpu/sampling/run.py:166-174)."""
    out = (rng.normal(size=(4, 8, 8, 27)) * 0.6).astype(np.float32)
    key = jax.random.PRNGKey(9)
    k_sel, k_pix = jax.random.split(key)
    means, log_scales, logits = jlosses.decoder_output_to_likelihood_params(
        out, "disc_logistic_mix", 3)
    pick = jax.random.categorical(k_sel, logits, axis=-1)
    u = jax.random.uniform(k_pix, pick.shape, minval=1e-5,
                           maxval=1.0 - 1e-5)
    for mode in ("mean", "sample"):
        want = _np(jrun.decoder_pixels(jnp.asarray(out), key,
                                       "disc_logistic_mix", 3, mode))
        got = trun.decoder_pixels(
            _t(out), "disc_logistic_mix", 3, mode,
            u=_t(u) if mode == "sample" else None,
            pick=torch.from_numpy(np.array(pick)) if mode == "sample"
            else None).numpy()
        assert got.shape == want.shape == (4, 8, 8, 3)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    drawn = trun.decoder_pixels(_t(out), "disc_logistic_mix", 3, "sample",
                                generator=torch.Generator().manual_seed(1))
    assert float(drawn.min()) >= 0.0 and float(drawn.max()) <= 1.0


# -- the IWAE estimate and the train step -------------------------------------

Z, B, K, CHUNK = 8, 8, 20, 10
ARCH = dict(z_dim=Z, widths=(8, 16), blocks_per_stage=1,
            image_shape=(32, 32, 3), upsample="conv_transpose",
            activation="silu", norm="rms", likelihood="disc_logistic_mix",
            mix_components=3)


def test_iwae_of_the_mixture_matches_jax_make_iwae_fn():
    """IWAE-20 in chunks of 10 (the op scoring [10·B] decodings beside
    x's B rows) on JAX's noise, same converted weights."""
    rng = np.random.default_rng(21)
    x = (rng.integers(0, 256, size=(B, 32, 32, 3)) / 255.0).astype(
        np.float32)
    fmodel = FlaxVAE(dtype=jnp.float32, **ARCH)
    params = fmodel.init(jax.random.PRNGKey(0), x[:1], np.zeros(
        (1, Z), np.float32))["params"]
    tmodel = ResNetVAE(dtype=torch.float32, **ARCH)
    tmodel.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, params)))
    key = jax.random.PRNGKey(4)
    jfn = jax_make_iwae_fn(fmodel, "disc_logistic_mix", K, CHUNK)
    with jdispatch.backend("jnp"):
        want = np.asarray(jfn(params, None, x * 2.0 - 1.0, x, key))
    eps = np.stack([np.asarray(jax.random.normal(kk, (CHUNK, B, Z)))
                    for kk in jax.random.split(key, K // CHUNK)])
    fn = make_iwae_fn(tmodel, "disc_logistic_mix", K, CHUNK)
    with torch.no_grad():
        got = fn(_t(x * 2.0 - 1.0), _t(x), eps=_t(eps)).numpy()
    assert got.shape == (B,) and np.all(np.isfinite(got))
    # as the other IWAE parity tests: f32 nets, 3072-term sums
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-2)


def _port_cfg(cfg_j):
    return config_from_dict(json.loads(cfg_j.to_json()))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _scale_rel(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.array(want, np.float32))
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.fixture(scope="module")
def steps():
    """Three tiny flagship steps with the K=3 mixture head, both packages,
    JAX's u, ε and z_p handed to the port."""
    cfg_j = tiny_config("cifar_advprior_resnet", **{
        "train.batch_size": 8, "train.beta_warmup_steps": 2, **MIX})
    m = cfg_j.model
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
              for _ in range(3)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "build_model", lambda mc: FlaxVAE(
            z_dim=m.z_dim, widths=tuple(m.widths),
            blocks_per_stage=m.blocks_per_stage,
            image_shape=tuple(m.image_shape), upsample=m.upsample,
            activation=m.activation, norm=m.norm, likelihood=m.likelihood,
            mix_components=m.mix_components, dtype=jnp.float32))
        fns = jstep.make_train_fns(cfg_j)
        state = fns.init_fn(jax.random.PRNGKey(0))
        step = jax.jit(fns.train_step)
        j_states, j_metrics = [state], []
        for im in images:
            state, met = step(state, {"image": im})
            j_states.append(state)
            j_metrics.append({k: float(v) for k, v in met.items()})
    cfg_t = _port_cfg(cfg_j)
    tfns = tstep.make_train_fns(cfg_t, device="cpu", dtype=torch.float32)
    ts = tfns.init_fn(cfg_t.train.seed)
    s0 = j_states[0]
    ts.model.load_state_dict(params_from_flax(_np_tree(s0.params)))
    ts.d.load_state_dict(d_params_from_flax(_np_tree(s0.d_params)))
    p0 = {k: v.clone() for k, v in ts.model.state_dict().items()}
    t_metrics, mu0 = [], None
    for t, im in enumerate(images):
        k_deq, k_g, *k_ds = jax.random.split(
            jax.random.fold_in(s0.rng, t), 2 + cfg_j.adversarial.n_critic)
        noise = {"u": _t(jax.random.uniform(k_deq, im.shape)),
                 "eps": _t(jax.random.normal(k_g, (8, m.z_dim))),
                 "z_p": _t(jnp.stack([jax.random.normal(
                     jax.random.split(kk)[1], (8, m.z_dim)) for kk in k_ds]))}
        ts, met = tfns.train_step(ts, {"image": torch.from_numpy(im)},
                                  noise=noise)
        t_metrics.append({k: float(v) for k, v in met.items()})
        if t == 0:
            mu0 = [mm.clone() for mm in ts.opt.mu]
    return dict(j_states=j_states, j_metrics=j_metrics, ts=ts,
                t_metrics=t_metrics, mu0=mu0, p0=p0)


def test_mixture_step_metrics_match_jax(steps):
    for got, want in zip(steps["t_metrics"], steps["j_metrics"]):
        assert set(got) == set(want)
        for k in want:
            if k == "d_acc":
                assert abs(got[k] - want[k]) <= 0.5 / 8 + 1e-7, k
            else:
                # f32 ResNets, 3072-pixel mixture sums (|recon| ~ 2e4)
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           atol=1e-3, err_msg=k)


def test_mixture_step_moments_and_param_change_match_jax(steps):
    """G's first moments after step 0 (≤ 1e-3) and Δθ after 3 steps
    (≤ 1e-2), scale-relative per tensor, the 27-channel head included."""
    ts = steps["ts"]
    names = [n for n, _ in ts.model.named_parameters()]
    want_mu = params_from_flax(_np_tree(
        steps["j_states"][1].opt_state[1][0].mu))
    got_mu = dict(zip(names, steps["mu0"]))
    assert set(got_mu) == set(want_mu)
    assert max(_scale_rel(got_mu[n], want_mu[n].numpy())
               for n in want_mu) <= 1e-3
    want = params_from_flax(_np_tree(steps["j_states"][-1].params))
    want0 = params_from_flax(_np_tree(steps["j_states"][0].params))
    got, p0 = ts.model.state_dict(), steps["p0"]
    assert max(_scale_rel(got[n] - p0[n], (want[n] - want0[n]).numpy())
               for n in want) <= 1e-2


def test_disc_logistic_mix_trains_evals_samples():
    """The port alone: the K=3 head trains (the ELBO improves over 30
    steps), ``evaluate_nll`` scores it finitely, and both pixel modes of
    the sampler stay in [0, 1] (tests/test_train.py:630)."""
    cfg = _port_cfg(tiny_config("cifar_advprior_resnet", **MIX))
    fns = tstep.make_train_fns(cfg, device="cpu")
    state = fns.init_fn(0)
    batch = {"image": torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (cfg.train.batch_size, 32, 32, 3), dtype=np.uint8))}
    hist = []
    for _ in range(30):
        state, m = fns.train_step(state, batch)
        hist.append({k: float(v) for k, v in m.items()})
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["elbo"] > hist[0]["elbo"], (hist[0], hist[-1])
    res = evaluate_nll(cfg, state.model, state.d,
                       batch["image"][:8].numpy(), k=8, chunk=4,
                       batch_size=8, device="cpu")
    assert np.isfinite(res["bits_per_dim"])
    for mode in ("mean", "sample"):
        imgs = trun.generate_samples(state.model, 4, cfg.model.z_dim,
                                     cfg.model.likelihood, 3, mode=mode,
                                     seed=1)
        assert tuple(imgs.shape) == (4, 32, 32, 3)
        assert float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0
