"""The port's IWAE-k training objective (``train.objective='iwae'``)
against ``apv_tpu.training.losses.iwae_objective``.

On the reference's linear toy model (explicit encoder/decoder weights) the
port's ``iwae_objective`` is handed JAX's ε [k, B, Z] and must give the
same bound, metrics and gradients as ``jax.grad`` of the reference, for
both estimators ('reparam' and 'dreg'), under the standard prior, the two
trained priors (whose parameters are θ-side) and the adversarial D. The
reference's identities are mirrored on the port: the two estimators share
the bound and the decoder gradient but not the encoder's, and at k = 1
'reparam' is the naive MC-ELBO gradient and 'dreg' the path-only (STL)
one. Then one ``cifar_advprior_resnet`` step with ``iwae_grad=dreg`` and
one ``mnist_advprior`` step with ``iwae_grad=reparam`` run through both
``make_train_fns``.

Tolerances: values element-wise 1e-5 relative (f32 sums of a few terms);
gradients scale-relative ≤ 1e-3 per tensor, as the other parity tests.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from conftest import tiny_config
from apv_tpu.core import distributions as JD
from apv_tpu.core import flow as jflow
from apv_tpu.data.preprocess import pack_bits
from apv_tpu.models.conv_vae import ConvVAE as FlaxConvVAE
from apv_tpu.models.resnet_vae import ResNetVAE as FlaxVAE
from apv_tpu.ops import dispatch as jdispatch
from apv_tpu.training import losses as JL
from apv_tpu.training import step as jstep
from apv_tpu_torch import ops
from apv_tpu_torch.convert import (d_params_from_flax, flow_from_flax,
                                   params_from_flax)
from apv_tpu_torch.core import distributions as TD
from apv_tpu_torch.models.common import PriorMixin, make_prior
from apv_tpu_torch.training import losses as TL
from apv_tpu_torch.training import step as tstep
from apv_tpu_torch.utils.config import config_from_dict

torch.set_num_threads(1)

B, DX, Z, K = 16, 12, 4, 5
BETA = 0.7


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the toy model --------------------------------------------------------------

def _toy_params(prior):
    rng = np.random.default_rng(0)
    p = {"enc_w": rng.normal(0, 0.3, (DX, 2 * Z)).astype(np.float32),
         "dec_w": rng.normal(0, 0.3, (Z, DX)).astype(np.float32)}
    if prior == "gaussian":
        p["prior"] = {"mu": rng.normal(0, 0.3, Z).astype(np.float32),
                      "log_sigma": rng.normal(0, 0.2, Z).astype(np.float32)}
    elif prior == "flow":
        flow = jflow.init_flow(jax.random.PRNGKey(2), Z, n_layers=2,
                               hidden=8)
        for i, layer in enumerate(flow["layers"]):
            layer["w3"] = 0.2 * jax.random.normal(jax.random.PRNGKey(i),
                                                  layer["w3"].shape)
        p["prior"] = jax.tree.map(np.asarray, flow)
    return p


def _jax_fns(prior):
    def encode(p, x):
        mean, logvar = jnp.split(x @ p["enc_w"], 2, axis=-1)
        return mean, jnp.tanh(logvar)

    def decode(p, z):
        return z @ p["dec_w"]

    prior_lp = None
    if prior == "gaussian":
        def prior_lp(p, z):
            return jnp.sum(JD.gaussian_logpdf(
                z, p["prior"]["mu"], 2.0 * p["prior"]["log_sigma"]), -1)
    elif prior == "flow":
        def prior_lp(p, z):
            return jflow.flow_logpdf(p["prior"], z)
    return encode, decode, prior_lp


class _Toy(PriorMixin, nn.Module):
    """The reference's linear toy, with the port's prior modules."""

    def __init__(self, p, prior):
        super().__init__()
        self.enc_w = nn.Parameter(_t(p["enc_w"]))
        self.dec_w = nn.Parameter(_t(p["dec_w"]))
        self.prior = make_prior(prior, Z, 2, 8)
        if prior == "gaussian":
            self.prior.load_state_dict({k: _t(v)
                                        for k, v in p["prior"].items()})
        elif prior == "flow":
            flow = flow_from_flax(p["prior"])
            sd = {f"whiten.{k}": v for k, v in flow["whiten"].items()}
            for i, layer in enumerate(flow["layers"]):
                sd.update({f"layers.{i}.{k}": v for k, v in layer.items()})
            self.prior.load_state_dict(sd)

    def encode(self, x):
        mean, logvar = (x @ self.enc_w).chunk(2, dim=-1)
        return mean, torch.tanh(logvar)

    def decode(self, z):
        return z @ self.dec_w

    def named_grads_like(self, grads):
        names = [n for n, _ in self.named_parameters()]
        return dict(zip(names, grads))


def _x():
    rng = np.random.default_rng(1)
    return (rng.random((B, DX)) < 0.4).astype(np.float32)


def _d_params():
    rng = np.random.default_rng(3)
    return {"w": rng.normal(0, 0.5, (Z,)).astype(np.float32)}


def _jax_objective(prior, k, est, variant, key):
    encode, decode, prior_lp = _jax_fns(prior)
    x = jnp.asarray(_x())
    w = jnp.asarray(_d_params()["w"])
    d_apply = None if variant is None else (lambda z: jnp.tanh(z @ w))

    def fn(p):
        obj, aux, _ = JL.iwae_objective(
            encode, decode, p, x, x, key, "bernoulli", k,
            jnp.float32(BETA), est, prior_logpdf_p=prior_lp,
            d_apply=d_apply, adv_variant=variant, adv_weight=0.5)
        return obj, aux
    return fn


def _port_objective(model, prior, k, est, variant, eps):
    x = _t(_x())
    w = _t(_d_params()["w"])
    d = None if variant is None else (lambda z: torch.tanh(z @ w))
    return TL.iwae_objective(model, x, x, "bernoulli", k, BETA, est,
                             trained_prior=prior != "standard", d=d,
                             adv_variant=variant, adv_weight=0.5, eps=eps)


def _eps(key, k):
    return _t(jax.random.normal(key, (k, B, Z), jnp.float32))


def _flat_grads(tree):
    """A reference gradient tree keyed like the toy's named_parameters."""
    out = {"enc_w": tree["enc_w"], "dec_w": tree["dec_w"]}
    prior = tree.get("prior")
    if prior is not None and "layers" in prior:
        flow = flow_from_flax(jax.tree.map(np.asarray, prior))
        for k, v in flow["whiten"].items():
            out[f"prior.whiten.{k}"] = v
        for i, layer in enumerate(flow["layers"]):
            out.update({f"prior.layers.{i}.{k}": v for k, v in layer.items()})
    elif prior is not None:
        out.update({f"prior.{k}": v for k, v in prior.items()})
    return {k: np.asarray(v) for k, v in out.items()}


CASES = [(est, prior, variant)
         for est in ("reparam", "dreg")
         for prior, variant in (("standard", None), ("gaussian", None),
                                ("flow", None),
                                ("standard", "learned_prior"),
                                ("gaussian", "aae"))]


@pytest.mark.parametrize("est,prior,variant", CASES)
def test_iwae_objective_matches_jax(est, prior, variant):
    """Bound, metrics and gradients (the encoder's, the decoder's and the
    trained prior's) against jax.grad of the reference, on JAX's ε."""
    key = jax.random.PRNGKey(5)
    p = _toy_params(prior)
    with jdispatch.backend("jnp"):
        fn = _jax_objective(prior, K, est, variant, key)
        (want, want_aux), g = jax.value_and_grad(fn, has_aux=True)(
            jax.tree.map(jnp.asarray, p))
    model = _Toy(p, prior)
    got, aux, z_q = _port_objective(model, prior, K, est, variant,
                                    _eps(key, K))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for name in ("iwae_bound", "recon", "kl"):
        np.testing.assert_allclose(float(aux[name]), float(want_aux[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    if variant is not None:
        np.testing.assert_allclose(float(aux["g_adv"]),
                                   float(want_aux["g_adv"]), rtol=1e-5)
    assert z_q.shape == (B, Z) and not z_q.requires_grad
    grads = model.named_grads_like(torch.autograd.grad(
        got, list(model.parameters())))
    want_g = _flat_grads(g)
    assert set(grads) == set(want_g)
    for name, v in want_g.items():
        assert _rel(grads[name].numpy(), v) <= 1e-3, name


def test_dreg_equals_reparam_for_decoder_params():
    """Both estimators give the decoder Σ_i w̃_i ∂recon_i/∂θ and the same
    bound; the encoder's gradients differ (w̃² and no score term), so DReG
    is not falling through to reparam."""
    key = jax.random.PRNGKey(7)
    model = _Toy(_toy_params("standard"), "standard")
    out = {}
    for est in ("reparam", "dreg"):
        obj, _, _ = _port_objective(model, "standard", 8, est, None,
                                    _eps(key, 8))
        out[est] = (obj, model.named_grads_like(
            torch.autograd.grad(obj, list(model.parameters()))))
    np.testing.assert_allclose(float(out["dreg"][0]),
                               float(out["reparam"][0]), rtol=1e-6)
    torch.testing.assert_close(out["dreg"][1]["dec_w"],
                               out["reparam"][1]["dec_w"], rtol=0, atol=1e-5)
    diff = (out["dreg"][1]["enc_w"] - out["reparam"][1]["enc_w"]).abs()
    assert float(diff.max()) > 1e-4


def _manual_k1(model, eps, stop_score):
    """Single-sample MC-ELBO on the same draw; ``stop_score`` detaches q's
    parameters in log q (the STL gradient)."""
    x = _t(_x())
    mean, logvar = model.encode(x)
    z = ops.reparam_sample(mean, logvar, 1, eps=eps)[0]
    m, lv = (mean.detach(), logvar.detach()) if stop_score else (mean,
                                                                 logvar)
    recon = TL.recon_log_likelihood(x, model.decode(z), "bernoulli")
    logp0 = torch.sum(TD.standard_gaussian_logpdf(z), -1)
    logq = torch.sum(TD.gaussian_logpdf(z, m, lv), -1)
    return torch.mean(recon + BETA * (logp0 - logq))


def _grads(model, value):
    return model.named_grads_like(torch.autograd.grad(
        value, list(model.parameters())))


def test_k1_reparam_is_naive_mc_elbo():
    eps = _eps(jax.random.PRNGKey(11), 1)
    model = _Toy(_toy_params("standard"), "standard")
    obj, _, _ = _port_objective(model, "standard", 1, "reparam", None, eps)
    naive = _manual_k1(model, eps, stop_score=False)
    np.testing.assert_allclose(float(obj), float(naive), rtol=1e-5)
    g_obj, g_naive = _grads(model, obj), _grads(model, naive)
    for k in g_obj:
        torch.testing.assert_close(g_obj[k], g_naive[k], rtol=0, atol=1e-5)


def test_k1_dreg_is_stl():
    """k=1 DReG is the path-only gradient, which differs from the naive
    one (the score term is real)."""
    eps = _eps(jax.random.PRNGKey(13), 1)
    model = _Toy(_toy_params("standard"), "standard")
    obj, _, _ = _port_objective(model, "standard", 1, "dreg", None, eps)
    g_dreg = _grads(model, obj)
    g_stl = _grads(model, _manual_k1(model, eps, stop_score=True))
    g_naive = _grads(model, _manual_k1(model, eps, stop_score=False))
    for k in g_dreg:
        torch.testing.assert_close(g_dreg[k], g_stl[k], rtol=0, atol=1e-5)
    assert float((g_stl["enc_w"] - g_naive["enc_w"]).abs().max()) > 1e-4


def test_iwae_objective_refuses_an_unknown_estimator():
    model = _Toy(_toy_params("standard"), "standard")
    with pytest.raises(ValueError, match="unknown iwae grad estimator"):
        _port_objective(model, "standard", 2, "score", None, None)


# -- one make_train_fns step ---------------------------------------------------

def _flax_vae(m):
    if m.family == "conv":
        return FlaxConvVAE(z_dim=m.z_dim, widths=tuple(m.widths),
                           dense=m.dense, image_shape=tuple(m.image_shape),
                           dtype=jnp.float32)
    return FlaxVAE(z_dim=m.z_dim, widths=tuple(m.widths),
                   blocks_per_stage=m.blocks_per_stage,
                   image_shape=tuple(m.image_shape), upsample=m.upsample,
                   activation=m.activation, norm=m.norm, dtype=jnp.float32)


@pytest.mark.parametrize("preset,est", [("cifar_advprior_resnet", "dreg"),
                                        ("mnist_advprior", "reparam")])
def test_iwae_train_step_matches_jax(preset, est):
    """One step with train.objective=iwae (k=3): the k samples folded into
    the decoder batch, the likelihood read against x's B rows, D trained
    on sample 0. JAX's dequantization u, ε [k, B, Z] and z_p replayed.
    Metrics 1e-4 relative; Adam's first moments (the clipped gradients)
    scale-relative ≤ 1e-3 per tensor."""
    k, b = 3, 8
    cfg_j = tiny_config(preset, **{
        "train.batch_size": b, "train.beta_warmup_steps": 0,
        "train.objective": "iwae", "train.iwae_k": k,
        "train.iwae_grad": est})
    z_dim = cfg_j.model.z_dim
    shape = (b, *cfg_j.model.image_shape)
    rng = np.random.default_rng(0)
    if cfg_j.data.binarize:
        name = "image_packed"
        image = pack_bits((rng.random(shape) < 0.3).astype(np.uint8))
    else:
        name = "image"
        image = rng.integers(0, 256, shape, dtype=np.uint8)
    with pytest.MonkeyPatch.context() as mp, jdispatch.backend("jnp"):
        mp.setattr(jstep, "build_model", _flax_vae)
        fns = jstep.make_train_fns(cfg_j)
        state = fns.init_fn(jax.random.PRNGKey(0))
        j_after, j_met = jax.jit(fns.train_step)(state, {name: image})
    step_key = jax.random.fold_in(state.rng, 0)
    k_deq, k_g, *k_ds = jax.random.split(step_key,
                                         2 + cfg_j.adversarial.n_critic)
    noise = {"eps": _t(jax.random.normal(k_g, (k, b, z_dim))),
             "z_p": _t(jnp.stack([jax.random.normal(jax.random.split(kk)[1],
                                                    (b, z_dim))
                                  for kk in k_ds]))}
    if not cfg_j.data.binarize:
        noise["u"] = _t(jax.random.uniform(k_deq, shape))
    cfg_t = config_from_dict(json.loads(cfg_j.to_json()))
    tfns = tstep.make_train_fns(cfg_t, device="cpu", dtype=torch.float32)
    ts = tfns.init_fn(cfg_t.train.seed)
    np_tree = lambda t: jax.tree.map(np.asarray, t)        # noqa: E731
    ts.model.load_state_dict(params_from_flax(np_tree(state.params)))
    ts.d.load_state_dict(d_params_from_flax(np_tree(state.d_params)))
    ts, t_met = tfns.train_step(ts, {name: torch.from_numpy(image)},
                                noise=noise)
    j_met = {kk: float(v) for kk, v in j_met.items()}
    t_met = {kk: float(v) for kk, v in t_met.items()}
    assert set(t_met) == set(j_met) == {
        "iwae_bound", "recon", "kl", "elbo", "g_adv", "loss", "grad_norm",
        "d_loss", "d_acc", "beta"}
    for kk in j_met:
        if kk == "d_acc":
            assert abs(t_met[kk] - j_met[kk]) <= 0.5 / b + 1e-7
        else:
            np.testing.assert_allclose(t_met[kk], j_met[kk], rtol=1e-4,
                                       atol=1e-3, err_msg=kk)
    want = params_from_flax(np_tree(j_after.opt_state[1][0].mu))
    got = dict(zip([n for n, _ in ts.model.named_parameters()], ts.opt.mu))
    assert set(got) == set(want)
    worst = max(_rel(got[kk].numpy(), want[kk].numpy()) for kk in want)
    assert worst <= 1e-3, worst
