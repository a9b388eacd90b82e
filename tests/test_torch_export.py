"""The port's serving export (``apv_tpu_torch/serving.py``) against
``apv_tpu/serving.py``, on the CPU at tiny widths.

* int8: the reference's ``quantize_params_int8`` then
  ``dequantize_params``, carried through ``convert.py``, equals the port's
  quantize-then-dequantize of the converted weights, over the same set of
  leaves; the error bound of ``tests/test_serving.py``.
* The scorer artifact (a CPU trace, so its custom ops run their plain
  versions) equals ``make_scorer`` fed the same Philox ε, serves two
  batch sizes, and holds the four kernels' ``torch.ops.apv`` nodes; its
  baked log Z agrees with the reference's estimate within the Monte
  Carlo standard error.
* The sampler artifacts pass ``tests/test_serving.py``'s checks.
* MALA's closed-form gradient equals ``autograd``'s.
* ``api.export_artifact``'s refusals, its default path and EMA weights,
  and the CLI passing ``--temperature``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from apv_tpu import serving as jserving
from apv_tpu.eval.iwae_eval import estimate_log_partition as jax_log_z
from apv_tpu.models import LatentDiscriminator as FlaxD
from apv_tpu.models import build_model as jbuild
from apv_tpu_torch import api, cli
from apv_tpu_torch import serving
from apv_tpu_torch.convert import d_params_from_flax, params_from_flax
from apv_tpu_torch.core.flow import init_flow
from apv_tpu_torch.eval.iwae_eval import estimate_log_partition
from apv_tpu_torch.models import LatentDiscriminator, build_model
from apv_tpu_torch.models.gaussian_prior import GaussianPrior
from apv_tpu_torch.ops import kernels as K
from apv_tpu_torch.sampling.run import (latent_d_grad,
                                        shaped_prior_logp,
                                        shaped_prior_logp_grad)
from apv_tpu_torch.training.step import make_train_fns
from apv_tpu_torch.utils import checkpoint as ckpt
from apv_tpu_torch.utils.config import config_from_dict

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _no_stack_traces():
    """The traces here record no Python stack trace a node (torch.fx's
    ``do_not_emit_stack_traces``, where this torch has it): collecting
    them is about a sixth of this file's time on the CPU. The artifacts
    are the same programs."""
    with pytest.MonkeyPatch.context() as mp:
        if hasattr(torch.fx.config, "do_not_emit_stack_traces"):
            mp.setattr(torch.fx.config, "do_not_emit_stack_traces", True)
        yield


def _port_cfg(preset, **over):
    return config_from_dict(json.loads(tiny_config(preset, **over).to_json()))


def _state(cfg, seed=0):
    return make_train_fns(cfg, device="cpu",
                          dtype=torch.float32).init_fn(seed)


def _images(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((b, *cfg.model.image_shape)).astype(np.float32)
    if cfg.data.binarize:
        x = (x < 0.4).astype(np.float32)
    return torch.from_numpy(x)


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset,over", [
    ("mnist_vae", {"model.dense": 256}),
    ("cifar_flow", {})])
def test_int8_matches_the_reference(preset, over):
    """On the flax params tree of the preset (its shapes from
    ``jax.eval_shape``, its values random normals)."""
    cfg_j = tiny_config(preset, **over)
    h, w, c = cfg_j.model.image_shape
    shapes = jax.eval_shape(
        jbuild(cfg_j.model).init, jax.random.PRNGKey(0),
        np.zeros((1, h, w, c), np.float32),
        np.zeros((1, cfg_j.model.z_dim), np.float32))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32), shapes)
    np_tree = lambda t: jax.tree.map(np.asarray, t)    # noqa: E731
    # eagerly, as the reference's export_sampler quantizes
    q = jserving.quantize_params_int8(params)
    want = params_from_flax(np_tree(jserving.dequantize_params(q)))
    is_q = lambda x: isinstance(x, dict) and "__q8__" in x  # noqa: E731
    marks = jax.tree.map(
        lambda x: (np.ones(x["__q8__"].shape, np.float32) if is_q(x)
                   else np.zeros(np.shape(x), np.float32)), q, is_leaf=is_q)
    want_set = {k for k, v in params_from_flax(marks).items() if v.all()}

    model = build_model(_port_cfg(preset, **over).model, device="cpu",
                        dtype=torch.float32)
    model.load_state_dict(params_from_flax(np_tree(params)))
    tree = serving.quantize_params_int8(model)
    got = serving.dequantize_params(tree)
    got_set = {k for k, v in tree.items() if isinstance(v, dict)}
    assert got_set == want_set and want_set
    if preset == "cifar_flow":
        # the flow's w1..w3 are 2-D and past min_size at z=128, but not
        # kernel leaves: float in both packages
        assert not any(k.startswith("prior.") for k in got_set)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k in got_set:
        assert tree[k]["__q8__"].dtype == torch.int8


def test_quantize_roundtrip_error_bound():
    """tests/test_serving.py's bound on the port's functions: a Dense
    kernel (torch layout [out, in]) with per-column scales."""
    from apv_tpu_torch.models.common import Dense
    rng = np.random.default_rng(0)
    w = (rng.normal(0, 0.1, (128, 64)).astype(np.float32)
         * rng.random((1, 64), np.float32))
    layer = Dense(128, 64)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w.T.copy()))
        layer.bias.copy_(torch.from_numpy(
            rng.normal(0, 1, (64,)).astype(np.float32)))
    q = serving.quantize_params_int8(layer)
    assert q["weight"]["__q8__"].dtype == torch.int8
    assert torch.equal(q["bias"], layer.bias.detach())
    d = serving.dequantize_params(q)["weight"].numpy().T
    bound = np.abs(w).max(axis=0, keepdims=True) / 254.0 + 1e-8
    assert np.all(np.abs(d - w) <= bound)


# ---------------------------------------------------------------------------
# the scorer artifact
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scorers(tmp_path_factory):
    """One adversarial MNIST scorer (bernoulli, log Z baked in) and one
    CIFAR scorer under the trained flow prior (disc_logistic): (cfg,
    model, d, log Z, artifact, path)."""
    root = tmp_path_factory.mktemp("scorers")
    out = {}
    for name in ("mnist_advprior", "cifar_flow"):
        cfg = _port_cfg(name)
        st = _state(cfg)
        d = st.d if cfg.adversarial.enabled else None
        path = serving.export_scorer(cfg, st.model, root / f"{name}.pt2",
                                     d=d, device="cpu")
        with torch.no_grad():
            log_z = (float(estimate_log_partition(d, cfg.model.z_dim,
                                                  seed=0, device="cpu"))
                     if d is not None else 0.0)
        out[name] = (cfg, st.model, d, log_z, serving.load_exported(path),
                     path)
    return out


@pytest.mark.parametrize("name", ["mnist_advprior", "cifar_flow"])
def test_scorer_artifact_equals_make_scorer(scorers, name):
    """The artifact draws ε from the Philox stream (seed, 0), as the
    reparam kernel does; make_scorer is handed the same ε. One artifact
    scores b = 1, 3 and 5; the bar is 1e-5 of the ELBO's scale."""
    cfg, model, d, log_z, art, _ = scorers[name]
    scorer = serving.make_scorer(cfg, model, d, log_z, device="cpu")
    z = cfg.model.z_dim
    for b, seed in ((1, 5), (3, 7), (5, 11)):
        x = _images(cfg, b, seed)
        got = art(x, torch.tensor(seed))
        eps = K.philox_normals(b * z, seed, 0).reshape(b, z)
        want = scorer(x, eps=eps)
        assert got.shape == (b,) and torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
        # and the key= route of make_scorer draws the same ε
        assert torch.equal(scorer(x, key=(seed, 0)), want)


def test_scorer_graphs_hold_the_four_kernel_ops(scorers):
    """What makes a trace on the card launch the kernels: the graph calls
    ``torch.ops.apv.*`` (the custom ops), one node each; the ResNet's
    ``norm=rms`` norms are ``apv::rmsnorm_act`` nodes beside the four."""
    from apv_tpu_torch.ops import export_ops  # noqa: F401  the ops' schemas
    seen = set()
    for *_, path in scorers.values():
        ep = torch.export.load(path)
        seen |= {str(n.target).split(".")[1] for n in ep.graph.nodes
                 if n.op == "call_function" and str(n.target).startswith(
                     "apv.")}
    assert seen == {"reparam", "kl", "bernoulli", "disc_logistic",
                    "rmsnorm_act"}


def test_pinned_scorer_batch(tmp_path):
    cfg = _port_cfg("mnist_vae", **{"eval.batch_size": 4})
    st = _state(cfg)
    art = serving.load_exported(serving.export_scorer(
        cfg, st.model, tmp_path / "pin.pt2", polymorphic_batch=False,
        device="cpu"))
    assert art(_images(cfg, 4), torch.tensor(0)).shape == (4,)
    with pytest.raises(Exception):
        art(_images(cfg, 3), torch.tensor(0))


def test_baked_log_z_within_the_reference_mc_error(scorers):
    """The port's log Z (its own draws, seed 0) against the reference's
    (``PRNGKey(0)``) on the same D: 100k draws each, within 4 of the
    port's jackknife standard errors."""
    cfg, _, d, log_z, *_ = scorers["mnist_advprior"]
    fd = FlaxD(tuple(cfg.adversarial.d_widths))
    dp = fd.init(jax.random.PRNGKey(3),
                 np.zeros((1, cfg.model.z_dim), np.float32))["params"]
    d_t = LatentDiscriminator(cfg.model.z_dim, tuple(cfg.adversarial.d_widths))
    d_t.load_state_dict(d_params_from_flax(jax.tree.map(np.asarray, dp)))
    want = float(jax_log_z(lambda p, z: fd.apply({"params": p}, z), dp,
                           cfg.model.z_dim, jax.random.PRNGKey(0)))
    with torch.no_grad():
        got, se = estimate_log_partition(d_t, cfg.model.z_dim, seed=0,
                                         with_se=True, device="cpu")
    assert abs(float(got) - want) <= 4 * float(se), (float(got), want,
                                                     float(se))


# ---------------------------------------------------------------------------
# the sampler artifacts (tests/test_serving.py's checks)
# ---------------------------------------------------------------------------

def _call(art, seed):
    return art(torch.tensor(seed))


@pytest.fixture(scope="module")
def mnist_vae_pair(tmp_path_factory):
    """The f32 and int8 sampler artifacts of one mnist_vae (dense 256)."""
    root = tmp_path_factory.mktemp("int8")
    cfg = _port_cfg("mnist_vae", **{"eval.batch_size": 8,
                                     "model.dense": 256})
    st = _state(cfg)
    p32 = serving.export_sampler(cfg, st.model, None, root / "s32.pt2",
                                 device="cpu")
    p8 = serving.export_sampler(cfg, st.model, None, root / "s8.pt2",
                                quantize="int8", device="cpu")
    return p32, p8


def test_sampler_export_roundtrip(mnist_vae_pair):
    art = serving.load_exported(mnist_vae_pair[0])
    imgs = _call(art, 7)
    assert imgs.shape == (8, 28, 28, 1)
    assert bool(((imgs >= 0) & (imgs <= 1)).all())
    assert torch.equal(_call(art, 7), imgs)
    assert not torch.equal(_call(art, 8), imgs)


def test_sampler_int8_quantized_export(mnist_vae_pair):
    p32, p8 = mnist_vae_pair
    assert p8.stat().st_size < 0.5 * p32.stat().st_size, (
        p8.stat().st_size, p32.stat().st_size)
    a = _call(serving.load_exported(p32), 7)
    b = _call(serving.load_exported(p8), 7)
    assert a.shape == b.shape
    assert float((a - b).abs().mean()) < 0.05
    assert bool(((b >= 0) & (b <= 1)).all())


@pytest.fixture(scope="module")
def adv(tmp_path_factory):
    """An mnist_advprior over the trained Gaussian base (moved off its
    zero init): its SIR, refined (4 MALA steps), ex-post Gaussian,
    ex-post GMM and ex-post flow artifacts, each called at one seed
    twice."""
    root = tmp_path_factory.mktemp("adv")
    cfg = _port_cfg("mnist_advprior", **{"eval.batch_size": 4,
                                          "model.prior": "gaussian"})
    st = _state(cfg)
    with torch.no_grad():
        st.model.prior.mu.add_(0.2)
        st.model.prior.log_sigma.sub_(0.1)
    zd = cfg.model.z_dim
    gauss = (torch.zeros(zd) + 0.3, torch.ones(zd) * 2.0)
    gmm = (torch.log(torch.tensor([0.6, 0.4])),
           torch.stack([torch.full((zd,), -3.0), torch.full((zd,), 3.0)]),
           torch.stack([torch.full((zd,), 0.5), torch.full((zd,), 2.0)]))
    flow = init_flow(zd, n_layers=2, hidden=8, mean=torch.full((zd,), 0.5),
                     std=torch.full((zd,), 2.0),
                     generator=torch.Generator().manual_seed(4))
    kinds = {"sir": dict(d=st.d), "refined": dict(d=st.d, refine_steps=4),
             "expost": dict(d=None, prior_moments=gauss),
             "gmm": dict(d=None, prior_moments=gmm),
             "flow": dict(d=None, prior_moments=flow)}
    out = {}
    for kind, kw in kinds.items():
        d = kw.pop("d")
        art = serving.load_exported(serving.export_sampler(
            cfg, st.model, d, root / f"{kind}.pt2", device="cpu", **kw))
        out[kind] = (_call(art, 3), _call(art, 3))
    return cfg, st, gauss, out, root


def test_sampler_export_adversarial_sir(adv):
    out = adv[3]
    a, again = out["sir"]
    assert a.shape == (4, 28, 28, 1) and torch.equal(a, again)


def test_sampler_export_refined(adv):
    """The MALA steps unrolled into the graph (the closed-form gradient
    over the Gaussian base) moved the latents: the refined artifact
    differs from the SIR one (same seed, same pool)."""
    out = adv[3]
    a, b = out["sir"][0], out["refined"][0]
    assert b.shape == (4, 28, 28, 1)
    assert bool(((b >= 0) & (b <= 1)).all())
    assert not torch.equal(a, b)
    assert torch.equal(*out["refined"])


def test_sampler_export_refine_needs_discriminator(tmp_path):
    cfg = _port_cfg("mnist_vae", **{"eval.batch_size": 4})
    with pytest.raises(ValueError, match="no latent discriminator"):
        serving.export_sampler(cfg, _state(cfg).model, None,
                               tmp_path / "x.pt2", refine_steps=4,
                               device="cpu")


def test_sampler_export_expost_prior(adv, tmp_path):
    cfg, st, gauss, out, _ = adv
    a, (b, again) = out["sir"][0], out["expost"]
    assert b.shape == (4, 28, 28, 1)
    assert bool(((b >= 0) & (b <= 1)).all())
    assert not torch.equal(a, b) and torch.equal(b, again)
    with pytest.raises(ValueError, match="ex-post prior"):
        serving.export_sampler(cfg, st.model, st.d, tmp_path / "x.pt2",
                               refine_steps=3, prior_moments=gauss,
                               device="cpu")


@pytest.mark.parametrize("kind", ["gmm", "flow"])
def test_sampler_export_expost_gmm_prior(adv, kind):
    """The GMM's (log_w, means, vars) and the flow's params dict bake in
    as the Gaussian's do, and sample otherwise than it."""
    out = adv[3]
    a, (b, again) = out["expost"][0], out[kind]
    assert b.shape == (4, 28, 28, 1)
    assert bool(((b >= 0) & (b <= 1)).all())
    assert not torch.equal(a, b) and torch.equal(b, again)


def test_sampler_export_temperature(adv):
    """T tempers the trained Gaussian base of the SIR pool: the T=0.5
    artifact differs from the default (T=1) one; other priors refuse
    T≠1."""
    cfg, st, _, out, root = adv
    p05 = serving.export_sampler(cfg, st.model, st.d, root / "t05.pt2",
                                 temperature=0.5, device="cpu")
    a05 = _call(serving.load_exported(p05), 3)
    assert not torch.equal(a05, out["sir"][0])
    std = _port_cfg("mnist_vae", **{"eval.batch_size": 4})
    with pytest.raises(ValueError, match="temperature"):
        serving.export_sampler(std, _state(std).model, None,
                               root / "bad.pt2", temperature=0.5,
                               device="cpu")


# ---------------------------------------------------------------------------
# MALA's closed-form gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sn", [False, True])
@pytest.mark.parametrize("base", ["standard", "gaussian"])
def test_closed_form_mala_gradient_equals_autograd(sn, base):
    """∇_z log p*(z) written out (the base's, plus the D's layer by layer,
    SNDense as W/σ) against autograd of ``shaped_prior_logp``; z includes
    exact zeros of a pre-activation (LeakyReLU's derivative 1 there)."""
    torch.manual_seed(0)
    zd, temperature = 6, 0.7
    d = LatentDiscriminator(zd, (16, 16), spectral_norm=sn)
    with torch.no_grad():
        for p in d.parameters():
            p.copy_(torch.randn_like(p) * 0.5)
        d.layers[0].bias.zero_()
    z = torch.randn(9, zd, dtype=torch.float32)
    z[0] = 0.0                  # layer 0's pre-activation is exactly 0
    base_logp = base_grad = None
    if base == "gaussian":
        prior = GaussianPrior(zd)
        with torch.no_grad():
            prior.mu.copy_(torch.randn(zd) * 0.3)
            prior.log_sigma.copy_(torch.randn(zd) * 0.2)
        mu, var = prior.mu.detach(), prior.moments()[1].detach()

        def base_logp(zz):
            return prior(mu + (zz - mu) / temperature)

        def base_grad(zz):
            return -(zz - mu) / (temperature ** 2 * var)
    zz = z.clone().requires_grad_(True)
    lp = shaped_prior_logp(zz, d, base_logp)
    (want,) = torch.autograd.grad(lp.sum(), zz)
    with torch.no_grad():
        got_lp, got = shaped_prior_logp_grad(d, base_logp, base_grad)(z)
        logit, _ = latent_d_grad(d, z)
    torch.testing.assert_close(got_lp, lp.detach(), rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(logit, d(z), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# api.export_artifact and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(what="scorer", temperature=0.8), "temperature is sampler-only"),
    (dict(what="scorer", quantize="int8"), "quantize is sampler-only"),
    (dict(what="scorer", refine=2), "refine is sampler-only"),
    (dict(what="scorer", prior="expost"), "prior is sampler-only"),
    (dict(what="model"), "unknown artifact"),
    (dict(prior="bogus"), "unknown prior")])
def test_export_artifact_refusals(kw, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        api.export_artifact("mnist_vae", device="cpu",
                            overrides=[f"results_dir={tmp_path}"], **kw)


def test_cli_passes_temperature(monkeypatch, capsys):
    import apv_tpu_torch
    seen = {}

    def fake(preset, **kw):
        seen.update(kw, preset=preset)
        return "x.pt2"

    monkeypatch.setattr(apv_tpu_torch, "export_artifact", fake)
    assert cli.main(["export", "--preset", "cifar_gb", "--temperature",
                     "0.8", "--quantize", "int8", "--refine", "3",
                     "--device", "cpu"]) == 0
    assert (seen["preset"], seen["temperature"], seen["quantize"],
            seen["refine"], seen["device"]) == ("cifar_gb", 0.8, "int8", 3,
                                                "cpu")
    assert "exported sampler to x.pt2" in capsys.readouterr().out


def test_cli_export_refuses_a_tempered_scorer():
    with pytest.raises(SystemExit, match="temperature is sampler-only"):
        cli.main(["export", "--what", "scorer", "--temperature", "0.8",
                  "--device", "cpu"])


def test_export_artifact_writes_the_ema_scorer(tmp_path):
    """A port checkpoint with an EMA shadow: the default path
    ``<results>/<name>/scorer.pt2``, and the shadow's weights in it."""
    over = {"train.ema_decay": 0.5, "results_dir": str(tmp_path),
            "eval.batch_size": 4}
    cfg = _port_cfg("mnist_vae", **over)
    st = _state(cfg)
    with torch.no_grad():
        for p in st.ema_model.parameters():
            p.mul_(0.5)
    run = tmp_path / cfg.name
    ckpt.save_checkpoint(run / "checkpoints", st, 1)
    (run / "config.json").write_text(cfg.to_json())
    path = api.export_artifact(cfg, what="scorer", device="cpu")
    assert path == run / "scorer.pt2" and path.exists()
    x = _images(cfg, 3)
    got = serving.load_exported(path)(x, torch.tensor(2))
    scorer = serving.make_scorer(cfg, st.ema_model, device="cpu")
    torch.testing.assert_close(got, scorer(x, key=(2, 0)), rtol=1e-5,
                               atol=1e-3)
    raw = serving.make_scorer(cfg, st.model, device="cpu")(x, key=(2, 0))
    assert not torch.allclose(got, raw)
