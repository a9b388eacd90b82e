"""The port's trained priors against ``apv_tpu``'s: the flow functions, the
two prior modules, one train step of ``cifar_gb`` and of ``cifar_flow``
(and the standard prior's free-bits floor), the scorer, ``evaluate_nll``
and ``generate_samples`` under each prior, and the refusals.

Both sides run float32 models at ``tiny_config`` size from the same
converted weights, and the port is handed JAX's draws (re-derived with
JAX's own key splits). Tolerances, as in the other parity tests: values
element-wise (f32 sums in another order), gradients (Adam's first moments
after one step) scale-relative ≤ 1e-3.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from apv_tpu.core import flow as jflow
from apv_tpu.eval import run as jeval
from apv_tpu.data.preprocess import pack_bits
from apv_tpu.models.conv_vae import ConvVAE as FlaxConvVAE
from apv_tpu.models.discriminator import LatentDiscriminator as FlaxD
from apv_tpu.models.discriminator import d_apply_fn
from apv_tpu.models.flow_prior import FlowPrior as FlaxFlowPrior
from apv_tpu.models.gaussian_prior import GaussianPrior as FlaxGaussianPrior
from apv_tpu.models.resnet_vae import ResNetVAE as FlaxVAE
from apv_tpu.ops import dispatch as jdispatch
from apv_tpu.sampling import run as jrun
from apv_tpu.training import step as jstep
from apv_tpu_torch.convert import (d_params_from_flax, flow_from_flax,
                                   params_from_flax)
from apv_tpu_torch.core import flow as tflow
from apv_tpu_torch.eval import iwae_eval as tiwae
from apv_tpu_torch.eval import run as teval
from apv_tpu_torch.models import build_model
from apv_tpu_torch.models.flow_prior import FlowPrior
from apv_tpu_torch.models.gaussian_prior import GaussianPrior
from apv_tpu_torch.sampling import run as trun
from apv_tpu_torch.serving import make_sampler, make_scorer
from apv_tpu_torch.training import step as tstep
from apv_tpu_torch.utils.config import apply_overrides, config_from_dict

torch.set_num_threads(1)

Z = 8


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _port_cfg(cfg_j):
    return config_from_dict(json.loads(cfg_j.to_json()))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _random_flow(key, z_dim=Z, n_layers=4, hidden=16):
    """A flow away from the identity: nonzero last layers and whitening."""
    p = jflow.init_flow(key, z_dim, n_layers=n_layers, hidden=hidden)
    ks = iter(jax.random.split(jax.random.fold_in(key, 7), 4 + 2 * n_layers))
    p["whiten"] = {"mean": 0.5 * jax.random.normal(next(ks), (z_dim,)),
                   "log_std": 0.3 * jax.random.normal(next(ks), (z_dim,))}
    for layer in p["layers"]:
        layer["w3"] = 0.3 * jax.random.normal(next(ks), layer["w3"].shape)
        layer["b3"] = 0.3 * jax.random.normal(next(ks), layer["b3"].shape)
    return p


# -- core/flow.py -------------------------------------------------------------

def test_flow_forward_inverse_logpdf_match_jax(rng):
    p_j = _random_flow(jax.random.PRNGKey(0))
    p_t = flow_from_flax(_np_tree(p_j))
    z = (2.0 * rng.normal(size=(32, Z))).astype(np.float32)
    u_j, ld_j = jflow.flow_forward(p_j, z)
    u_t, ld_t = tflow.flow_forward(p_t, _t(z))
    # three f32 matmuls of width 16 a layer, each layer's rounding scaled
    # by the next ones' e^s (up to e^3): 1e-4
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tflow.flow_logpdf(p_t, _t(z)).numpy(),
                               np.asarray(jflow.flow_logpdf(p_j, z)),
                               rtol=1e-4, atol=1e-4)
    u = rng.normal(size=(32, Z)).astype(np.float32)
    z_t = tflow.flow_inverse(p_t, _t(u))
    np.testing.assert_allclose(z_t.numpy(),
                               np.asarray(jflow.flow_inverse(p_j, u)),
                               rtol=1e-4, atol=1e-4)
    # the inverse is exact: forward(inverse(u)) = u up to f32 rounding,
    # which four layers of e^±s (|s| ≤ 3) amplify: 1e-3
    np.testing.assert_allclose(tflow.flow_forward(p_t, z_t)[0].numpy(), u,
                               rtol=1e-3, atol=1e-3)


def test_fit_flow_with_jax_draws_matches_jax(rng):
    """fit_flow with JAX's shuffle, init draws and minibatch indices
    injected: the same AdamW steps on the same rows. The trace and the
    holdout-best params after 12 steps agree to 1e-4 relative (f32
    gradients summed in another order, through 12 Adam updates)."""
    n_layers, hidden, steps, batch = 2, 8, 12, 32
    z = (rng.normal(size=(80, 4)) * np.array([3.0, 1.0, 0.5, 2.0])
         + 1.0).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want_p, want_nll = jflow.fit_flow(key, z, n_layers=n_layers,
                                      hidden=hidden, steps=steps,
                                      batch=batch)
    k_init, k_perm, k_fit = jax.random.split(key, 3)
    perm = np.asarray(jax.random.permutation(k_perm, 80))
    draws, k = [], k_init
    for _ in range(n_layers):
        k, k1, k2 = jax.random.split(k, 3)
        draws.append((np.asarray(jax.random.normal(k1, (4, hidden))),
                      np.asarray(jax.random.normal(k2, (hidden, hidden)))))
    idx = np.stack([np.asarray(jax.random.randint(kk, (batch,), 0, 72))
                    for kk in jax.random.split(k_fit, steps)])
    got_p, got_nll = tflow.fit_flow(
        _t(z), n_layers=n_layers, hidden=hidden, steps=steps, batch=batch,
        perm=torch.from_numpy(perm), init_draws=draws,
        indices=torch.from_numpy(idx))
    np.testing.assert_allclose(got_nll.numpy(), np.asarray(want_nll),
                               rtol=1e-4, atol=1e-4)
    want_t = flow_from_flax(_np_tree(want_p))
    for a, b in zip(tflow.flow_leaves(got_p), tflow.flow_leaves(want_t)):
        assert _rel(a.numpy(), b.numpy()) <= 1e-4


# -- the prior modules ---------------------------------------------------------

def test_prior_modules_match_flax(rng):
    z = (1.5 * rng.normal(size=(16, Z))).astype(np.float32)
    u = rng.normal(size=(16, Z)).astype(np.float32)
    fg = FlaxGaussianPrior(Z)
    pg = {"mu": rng.normal(size=Z).astype(np.float32),
          "log_sigma": (0.3 * rng.normal(size=Z)).astype(np.float32)}
    tg = GaussianPrior(Z)
    tg.load_state_dict({k: _t(v) for k, v in pg.items()})
    ff = FlaxFlowPrior(Z, n_layers=4, hidden=16)
    pf = {"flow": _random_flow(jax.random.PRNGKey(1))}
    tf = FlowPrior(Z, n_layers=4, hidden=16)
    tf.load_state_dict(_flow_sd(pf))
    with torch.no_grad():
        for fmod, p, tmod in ((fg, pg, tg), (ff, pf, tf)):
            np.testing.assert_allclose(
                tmod(_t(z)).numpy(),
                np.asarray(fmod.apply({"params": p}, z)), rtol=1e-5,
                atol=1e-4)
            np.testing.assert_allclose(
                tmod.sample_from(_t(u)).numpy(),
                np.asarray(fmod.apply({"params": p}, u,
                                      method="sample_from")),
                rtol=1e-5, atol=1e-5)
        mu, var = tg.moments()
        want_mu, want_var = fg.apply({"params": pg}, method="moments")
        np.testing.assert_allclose(mu.numpy(), np.asarray(want_mu))
        np.testing.assert_allclose(var.numpy(), np.asarray(want_var),
                                   rtol=1e-6)


def _flow_sd(pf):
    flow = flow_from_flax(_np_tree(pf["flow"]))
    sd = {f"whiten.{k}": v for k, v in flow["whiten"].items()}
    for i, layer in enumerate(flow["layers"]):
        sd.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return sd


@pytest.mark.parametrize("prior", ["gaussian", "flow"])
def test_zero_init_is_the_standard_prior(prior):
    """At init each trained prior is N(0, I): its log-density and its draws
    equal the standard prior's, the encoder and decoder weights equal the
    standard model's of the same seed, and the flow's hidden layers are
    He-normal while its last layers are zero."""
    cfg = tiny_config("mnist_advprior")
    mc_s = _port_cfg(cfg).model
    mc_p = _port_cfg(tiny_config("mnist_advprior",
                                 **{"model.prior": prior})).model
    m_s = build_model(mc_s, device="cpu", seed=0)
    m_p = build_model(mc_p, device="cpu", seed=0)
    sd_s, sd_p = m_s.state_dict(), m_p.state_dict()
    for k, v in sd_s.items():
        assert torch.equal(v, sd_p[k]), k
    assert any(k.startswith("prior.") for k in sd_p)
    zs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(64, mc_p.z_dim)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(m_p.prior_logpdf(zs).numpy(),
                                   m_s.prior_logpdf(zs).numpy(), rtol=1e-6)
        assert torch.equal(m_p.prior_sample_from(zs), zs)
    if prior == "flow":
        for layer in m_p.prior.layers:
            assert float(layer["w3"].abs().max()) == 0.0
            assert float(layer["b3"].abs().max()) == 0.0
            assert 0.5 < float(layer["w1"].std() / (2.0 / mc_p.z_dim) ** .5)


# -- one train step of each preset --------------------------------------------

def _flax_vae(m):
    if m.family == "conv":
        return FlaxConvVAE(z_dim=m.z_dim, widths=tuple(m.widths),
                           dense=m.dense, image_shape=tuple(m.image_shape),
                           prior=m.prior, dtype=jnp.float32)
    return FlaxVAE(z_dim=m.z_dim, widths=tuple(m.widths),
                   blocks_per_stage=m.blocks_per_stage,
                   image_shape=tuple(m.image_shape), upsample=m.upsample,
                   activation=m.activation, norm=m.norm, prior=m.prior,
                   prior_flow_layers=m.prior_flow_layers,
                   prior_flow_hidden=m.prior_flow_hidden, dtype=jnp.float32)


def _perturb_prior(params):
    """Move the prior off its zero init, so every term has a gradient."""
    params = jax.tree.map(lambda a: a, params)
    if "gaussian_prior" in params:
        gp = params["gaussian_prior"]
        gp["mu"] = 0.3 * jax.random.normal(jax.random.PRNGKey(5), (Z,))
        gp["log_sigma"] = 0.2 * jax.random.normal(jax.random.PRNGKey(6),
                                                  (Z,))
    if "flow_prior" in params:
        flow = params["flow_prior"]["flow"]
        for i, layer in enumerate(flow["layers"]):
            k1, k2 = jax.random.split(jax.random.PRNGKey(10 + i))
            layer["w3"] = 0.05 * jax.random.normal(k1, layer["w3"].shape)
            layer["b3"] = 0.05 * jax.random.normal(k2, layer["b3"].shape)
        flow["whiten"]["mean"] = 0.1 * jnp.ones((Z,))
    return params


def _jax_step_noise(cfg, rng_key, shape):
    """Step 0's dequantization u, G's ε, the dispersion penalty's u
    (``fold_in(k_g, 1)``) and the critic's z_p."""
    b = shape[0]
    step_key = jax.random.fold_in(rng_key, 0)
    k_deq, k_g, *k_ds = jax.random.split(
        step_key, 2 + max(cfg.adversarial.n_critic, 1))
    noise = {"u": _t(jax.random.uniform(k_deq, shape, jnp.float32)),
             "eps": _t(jax.random.normal(k_g, (b, Z), jnp.float32)),
             "u_disp": _t(jax.random.normal(jax.random.fold_in(k_g, 1),
                                            (b, Z), jnp.float32))}
    if cfg.adversarial.enabled:
        noise["z_p"] = _t(jnp.stack([
            jax.random.normal(jax.random.split(k)[1], (b, Z), jnp.float32)
            for k in k_ds[:cfg.adversarial.n_critic]]))
    return noise


def _step_pair(preset, **extra):
    """One step of ``preset`` through both make_train_fns: (cfg, JAX
    metrics, JAX state after, port metrics, port state after)."""
    over = {"train.batch_size": 8, "train.beta_warmup_steps": 0, **extra}
    cfg_j = tiny_config(preset, **over)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "build_model", lambda mc: _flax_vae(mc))
        fns = jstep.make_train_fns(cfg_j)
        state = fns.init_fn(jax.random.PRNGKey(0))
        state = state.replace(params=_perturb_prior(state.params))
        rng = np.random.default_rng(0)
        shape = (8, *cfg_j.model.image_shape)
        if cfg_j.data.binarize:
            name = "image_packed"
            image = pack_bits((rng.random(shape) < 0.3).astype(np.uint8))
        else:
            name = "image"
            image = rng.integers(0, 256, shape, dtype=np.uint8)
        j_after, j_met = jax.jit(fns.train_step)(state, {name: image})
    cfg_t = _port_cfg(cfg_j)
    tfns = tstep.make_train_fns(cfg_t, device="cpu", dtype=torch.float32)
    ts = tfns.init_fn(cfg_t.train.seed)
    ts.model.load_state_dict(params_from_flax(_np_tree(state.params)),
                             strict=True)
    if ts.d is not None:
        ts.d.load_state_dict(d_params_from_flax(_np_tree(state.d_params)))
    ts, t_met = tfns.train_step(
        ts, {name: torch.from_numpy(image)},
        noise=_jax_step_noise(cfg_j, state.rng, shape))
    return (cfg_j, {k: float(v) for k, v in j_met.items()}, j_after,
            {k: float(v) for k, v in t_met.items()}, ts)


def _assert_step_matches(cfg_j, j_met, j_after, t_met, ts, keys):
    assert set(t_met) == set(j_met) == keys
    for k in j_met:
        if k == "d_acc":
            # a fraction over 2·B logits: one logit across 0 moves it 1/16
            assert abs(t_met[k] - j_met[k]) <= 0.5 / 8 + 1e-7
        else:
            # f32 ResNets that agree to ~1e-5 relative, 3072-pixel sums
            np.testing.assert_allclose(t_met[k], j_met[k], rtol=1e-4,
                                       atol=1e-3, err_msg=k)
    # Adam's first moments after one step, (1 − b1)·clip(g): the VAE's and
    # the prior's gradients, scale-relative per tensor ≤ 1e-3
    want = params_from_flax(_np_tree(j_after.opt_state[1][0].mu))
    got = dict(zip([n for n, _ in ts.model.named_parameters()], ts.opt.mu))
    assert set(got) == set(want)
    prior_keys = [k for k in want if k.startswith("prior.")]
    assert prior_keys == [] or all(float(want[k].abs().max()) > 0
                                   for k in prior_keys)
    worst = max(_rel(got[k].numpy(), want[k].numpy()) for k in want)
    assert worst <= 1e-3, worst


def test_cifar_gb_step_matches_jax():
    """cifar_gb (the Gaussian base under the adversarial D) with free bits:
    the analytic KL against (μ, 2·log σ), its per-dimension floor, and the
    D phase's z_p drawn from the base."""
    out = _step_pair("cifar_gb", **{"train.free_bits": 0.05})
    _assert_step_matches(*out, keys={"loss", "recon", "kl", "elbo", "g_adv",
                                     "grad_norm", "d_loss", "d_acc",
                                     "beta"})


def test_cifar_flow_step_matches_jax():
    """cifar_flow with the dispersion penalty and free bits: the MC KL
    against the flow, the total-KL floor, the penalty's inverse pass on
    the step's next base draw."""
    out = _step_pair("cifar_flow", **{"train.flow_dispersion_penalty": 2.0,
                                      "train.free_bits": 0.05})
    _assert_step_matches(*out, keys={"loss", "recon", "kl", "elbo",
                                     "grad_norm", "beta",
                                     "flow_dispersion"})


def test_standard_prior_free_bits_step_matches_jax():
    """The third prior family's floor: mnist_vae (the conv VAE, N(0, I))
    with free bits, the per-dimension floor of the KL against N(0, I)."""
    out = _step_pair("mnist_vae", **{"train.free_bits": 0.05})
    _assert_step_matches(*out, keys={"loss", "recon", "kl", "elbo",
                                     "grad_norm", "beta"})


# -- evaluate_nll and generate_samples ----------------------------------------

def _trained_prior_pair(prior):
    """(cfg_j, flax model, params, flax D or None, d_params, port model,
    port D or None) for a tiny ResNet with the given prior."""
    preset = "cifar_gb" if prior == "gaussian" else "cifar_flow"
    cfg_j = tiny_config(preset, **{"eval.batch_size": 8})
    fmodel = _flax_vae(cfg_j.model)
    params = fmodel.init(jax.random.PRNGKey(0),
                         np.zeros((1, 32, 32, 3), np.float32),
                         np.zeros((1, Z), np.float32))["params"]
    params = _perturb_prior(params)
    tmodel = build_model(_port_cfg(cfg_j).model, dtype=torch.float32,
                         device="cpu")
    tmodel.load_state_dict(params_from_flax(_np_tree(params)), strict=True)
    fd = d_params = td = None
    if cfg_j.adversarial.enabled:
        fd = FlaxD((32, 32))
        d_params = jax.tree.map(lambda a: 3.0 * a, fd.init(
            jax.random.PRNGKey(1), np.zeros((1, Z), np.float32))["params"])
        from apv_tpu_torch.models import LatentDiscriminator
        td = LatentDiscriminator(Z, (32, 32))
        td.load_state_dict(d_params_from_flax(_np_tree(d_params)))
    return cfg_j, fmodel, params, fd, d_params, tmodel.eval(), td


@pytest.mark.parametrize("prior", ["gaussian", "flow"])
def test_evaluate_nll_under_the_trained_prior_matches_jax(prior):
    """evaluate_nll scores the checkpoint's own prior: the flow exactly
    with log Z = 0 and no D; the Gaussian base under D, with log Z drawn
    from the current base. The port gets JAX's chunk noise and log-Z
    draws; per-sample scores agree to 2e-5 relative (f32 sums over 3072
    pixels and 4 weights), log Z to 1e-5."""
    cfg_j, fmodel, params, fd, d_params, tmodel, td = \
        _trained_prior_pair(prior)
    k, chunk, seed = 4, 2, 3
    with pytest.MonkeyPatch.context() as mp, jdispatch.backend("jnp"):
        mp.setattr(jeval, "build_model", lambda mc: fmodel)
        want = jeval.evaluate_nll(cfg_j, params, d_params, k=k, chunk=chunk,
                                  max_examples=16, per_sample=True,
                                  seed=seed, batch_size=8)
    cfg_t = _port_cfg(cfg_j)
    images = teval.eval_arrays(cfg_t, max_examples=16)["image"]
    np.testing.assert_array_equal(
        images, jeval.eval_arrays(cfg_j, None, 16)["image"])
    chunks = []
    for i in range(2):
        for kk in jax.random.split(jax.random.PRNGKey(seed + i), k // chunk):
            chunks.append(_t(jax.random.normal(kk, (chunk, 8, Z))))
    chunk_iter = iter(chunks)

    def jax_chunk(mean, logvar, n, *, generator=None, eps=None):
        return tiwae.ops.reparam_sample(mean, logvar, n,
                                        eps=next(chunk_iter))

    log_z_keys = jax.random.split(jax.random.PRNGKey(seed + 17), 20)
    log_z_draws = torch.stack([_t(jax.random.normal(kk, (5000, Z)))
                               for kk in log_z_keys])
    real_lp = teval.estimate_log_partition
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tiwae, "sample_posterior_chunk", jax_chunk)
        mp.setattr(teval, "estimate_log_partition",
                   lambda *a, **kw: real_lp(*a, draws=log_z_draws, **kw))
        got = teval.evaluate_nll(cfg_t, tmodel, td, images, k=k, chunk=chunk,
                                 per_sample=True, seed=seed, batch_size=8,
                                 device="cpu")
    assert got["adversarial_prior"] == (prior == "gaussian")
    np.testing.assert_allclose(got["log_partition"], want["log_partition"],
                               rtol=1e-5, atol=1e-5)
    if prior == "flow":
        assert got["log_partition"] == 0.0
    np.testing.assert_allclose(got["per_sample"], want["per_sample"],
                               rtol=2e-5, atol=1e-2)
    assert np.isfinite(got["bits_per_dim"])


@pytest.mark.parametrize("prior", ["gaussian", "flow"])
def test_scorer_under_the_trained_prior_matches_jax(prior):
    """make_scorer swaps N(0, I) for the trained prior on the same z, as
    the reference's ``_scorer_fn``: JAX's ε injected, per-sample ELBO to
    2e-5 relative (f32 sums over 3072 pixels)."""
    from apv_tpu import serving as jserving
    cfg_j, fmodel, params, fd, d_params, tmodel, td = \
        _trained_prior_pair(prior)
    x = (np.random.default_rng(4).integers(0, 256, (8, 32, 32, 3))
         / 255.0).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp, jdispatch.backend("jnp"):
        mp.setattr(jserving, "build_model", lambda mc: fmodel)
        want = jserving._scorer_fn(cfg_j, params, d_params, log_z=0.3)(x, 3)
    eps = _t(jax.random.normal(jax.random.PRNGKey(3), (8, Z), jnp.float32))
    got = make_scorer(_port_cfg(cfg_j), tmodel, td, 0.3, device="cpu")(
        torch.from_numpy(x), eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-2)


def _mala_draws(key, steps, n):
    """langevin_refine's per-step proposal normals and accept uniforms."""
    noise, unif = [], []
    for _ in range(steps):
        key, k_prop, k_acc = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(k_prop, (n, Z))))
        unif.append(np.asarray(jax.random.uniform(k_acc, (n,))))
    return _t(np.stack(noise)), _t(np.stack(unif))


@pytest.mark.parametrize("prior", ["gaussian", "flow"])
def test_generate_samples_from_the_trained_prior_matches_jax(prior):
    """generate_samples at T=0.7: the flow's inverse on the tempered base
    draw (model_prior); SIR over the tempered Gaussian base weighted by D,
    then 2 MALA steps on the tempered base's log-density plus D
    (model_base). JAX's draws replayed; images agree to 1e-4."""
    cfg_j, fmodel, params, fd, d_params, tmodel, td = \
        _trained_prior_pair(prior)
    n, temp = 6, 0.7
    key = jax.random.PRNGKey(9)
    kw_j = dict(model_prior=prior == "flow", model_base=prior == "gaussian",
                temperature=temp)
    if prior == "gaussian":
        kw_j.update(d_apply=d_apply_fn(fd), d_params=d_params,
                    refine_steps=2)
    with jdispatch.backend("jnp"):
        want, want_diag = jrun.generate_samples(
            fmodel, params, key, n, Z, "discretized_logistic", 3,
            return_diagnostics=True, **kw_j)
    k_z, _ = jax.random.split(key)
    if prior == "flow":
        draws = {"pool": _t(jax.random.normal(k_z, (n, Z)))}
    else:
        k_pool, k_sel, k_mala = jax.random.split(k_z, 3)
        pool = jax.random.normal(k_pool, (n * 16, Z))
        base = fmodel.apply({"params": params}, temp * pool,
                            method="prior_sample_from")
        logw = fd.apply({"params": d_params}, base)
        noise, unif = _mala_draws(k_mala, 2, n)
        draws = {"pool": _t(pool),
                 "pick": torch.from_numpy(np.asarray(
                     jax.random.categorical(k_sel, logw, shape=(n,)))),
                 "mala_noise": noise, "mala_uniforms": unif}
    got, diag = trun.generate_samples(
        tmodel, n, Z, "discretized_logistic", 3, d=td,
        model_prior=prior == "flow", model_base=prior == "gaussian",
        temperature=temp, refine_steps=2 if td is not None else 0,
        return_diagnostics=True, draws=draws)
    assert got.shape == (n, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert set(diag) == set(want_diag)
    for k in diag:
        np.testing.assert_allclose(diag[k], want_diag[k], rtol=1e-4)


# -- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("over,match", [
    ({"model.prior": "flow", "adversarial.enabled": True},
     "mutually exclusive"),
    ({"train.flow_dispersion_penalty": 1.0}, "requires model.prior='flow'"),
    ({"model.prior": "flow", "adversarial.enabled": False,
      "train.flow_dispersion_penalty": 1.0, "train.objective": "iwae"},
     "requires model.prior='flow'"),
    ({"train.objective": "iwae", "train.free_bits": 0.5},
     "free_bits applies to the elbo"),
    ({"train.objective": "iwae", "train.iwae_grad": "score"},
     "unknown iwae grad estimator"),
])
def test_train_step_refusals(over, match):
    cfg = _port_cfg(tiny_config("mnist_advprior", **over))
    with pytest.raises(ValueError, match=match):
        tstep.make_train_fns(cfg, device="cpu")


def test_sampling_and_model_refusals():
    cfg = _port_cfg(tiny_config("cifar_flow"))
    model = build_model(cfg.model, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="unknown model prior"):
        build_model(apply_overrides(cfg, ["model.prior=vamp"]).model,
                    device="cpu")
    with pytest.raises(ValueError, match="n_layers >= 2"):
        tflow.init_flow(Z, n_layers=1)
    gen = lambda **kw: trun.generate_samples(           # noqa: E731
        model, 2, Z, "discretized_logistic", 3, **kw)
    with pytest.raises(ValueError, match="model_prior"):
        gen(model_prior=True, d=lambda z: z.sum(-1))
    with pytest.raises(ValueError, match="model_base"):
        gen(model_base=True, model_prior=True)
    with pytest.raises(ValueError, match="temperature"):
        gen(temperature=0.7)
    with pytest.raises(ValueError, match="come as a pair"):
        trun.sample_prior(2, Z, base_from=lambda u: u)
    with pytest.raises(ValueError, match="temperature"):
        make_sampler(cfg, model, prior_moments=(torch.zeros(Z),
                                                torch.ones(Z)),
                     temperature=0.7, device="cpu")
    std = _port_cfg(tiny_config("cifar_advprior_resnet"))
    with pytest.raises(ValueError, match="temperature"):
        make_sampler(std, build_model(std.model, device="cpu"),
                     temperature=0.7, device="cpu")
    # the trained flow samples through make_sampler, tempered
    imgs = make_sampler(apply_overrides(cfg, ["eval.batch_size=3"]), model,
                        temperature=0.7, device="cpu")(0)
    assert imgs.shape == (3, 32, 32, 3) and torch.isfinite(imgs).all()
