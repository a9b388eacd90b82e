"""The port's biadversarial train step, R1 penalty and spectrally normalized
latent D against ``apv_tpu``'s, and the ``pixel_d`` score.

One step of tiny ``mnist_advprior`` and tiny ``cifar_advprior_resnet``
under ``adversarial.variant=biadversarial``, ``r1_gamma=1`` and
``d_spectral_norm=true`` runs through ``apv_tpu.training.step.
make_train_fns`` and the port's, from the same converted weights (the VAE
and the pixel D built in float32 on both sides) with JAX's noise handed to
the port. Tolerances as in the other step tests: metrics element-wise (f32
nets in another summation order), gradients (Adam's first moments after
one step) scale-relative ≤ 1e-3; the D's updated parameters where their
gradient stands above the f32 noise (below it Adam's step is ±lr whatever
the gradient's sign).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from apv_tpu.data.preprocess import pack_bits
from apv_tpu.eval import ood as jood
from apv_tpu.eval import run as jeval
from apv_tpu.models.conv_vae import ConvVAE as FlaxConvVAE
from apv_tpu.models.discriminator import PixelDiscriminator as FlaxPixelD
from apv_tpu.models.resnet_vae import ResNetVAE as FlaxVAE
from apv_tpu.training import step as jstep
from apv_tpu_torch import api
from apv_tpu_torch.convert import d_params_from_flax, params_from_flax
from apv_tpu_torch.eval import ood as tood
from apv_tpu_torch.eval import run as teval
from apv_tpu_torch.models import PixelDiscriminator
from apv_tpu_torch.training import step as tstep
from apv_tpu_torch.utils.checkpoint import save_checkpoint
from apv_tpu_torch.utils.config import config_from_dict

torch.set_num_threads(1)

BIADV = {"adversarial.variant": "biadversarial", "adversarial.r1_gamma": 1.0,
         "adversarial.d_spectral_norm": True,
         "adversarial.pixel_d_widths": "[8,16,16]",
         "adversarial.pixel_weight": 0.5, "adversarial.label_smoothing": 0.1}
KEYS = {"loss", "recon", "kl", "elbo", "g_adv", "g_px", "grad_norm",
        "d_loss", "d_acc", "d_r1", "px_d_loss", "px_d_acc", "px_d_r1",
        "beta"}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _port_cfg(cfg_j):
    return config_from_dict(json.loads(cfg_j.to_json()))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flax_vae(m):
    if m.family == "conv":
        return FlaxConvVAE(z_dim=m.z_dim, widths=tuple(m.widths),
                           dense=m.dense, image_shape=tuple(m.image_shape),
                           dtype=jnp.float32)
    return FlaxVAE(z_dim=m.z_dim, widths=tuple(m.widths),
                   blocks_per_stage=m.blocks_per_stage,
                   image_shape=tuple(m.image_shape), upsample=m.upsample,
                   activation=m.activation, norm=m.norm, dtype=jnp.float32)


def _batch(cfg, b):
    rng = np.random.default_rng(0)
    shape = (b, *cfg.model.image_shape)
    if cfg.data.binarize:
        return "image_packed", pack_bits(
            (rng.random(shape) < 0.3).astype(np.uint8))
    return "image", rng.integers(0, 256, shape, dtype=np.uint8)


def _jax_noise(cfg, rng_key, shape):
    """Step 0's dequantization u, G's ε ([k, B, Z] under the IWAE
    objective) and the critic's z_p (step.py's key splits)."""
    b, z = shape[0], cfg.model.z_dim
    k_deq, k_g, *k_ds = jax.random.split(jax.random.fold_in(rng_key, 0),
                                         2 + cfg.adversarial.n_critic)
    eps_shape = ((cfg.train.iwae_k, b, z) if cfg.train.objective == "iwae"
                 else (b, z))
    noise = {"eps": _t(jax.random.normal(k_g, eps_shape, jnp.float32)),
             "z_p": _t(jnp.stack([
                 jax.random.normal(jax.random.split(k)[1], (b, z),
                                   jnp.float32) for k in k_ds]))}
    if cfg.data.dequantize:
        noise["u"] = _t(jax.random.uniform(k_deq, shape, jnp.float32))
    return noise


def _step_pair(preset, **extra):
    over = {"train.batch_size": 8, "train.beta_warmup_steps": 0, **BIADV,
            **extra}
    cfg_j = tiny_config(preset, **over)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "build_model", _flax_vae)
        mp.setattr(jstep, "PixelDiscriminator",
                   lambda widths: FlaxPixelD(widths, dtype=jnp.float32))
        fns = jstep.make_train_fns(cfg_j)
        state = fns.init_fn(jax.random.PRNGKey(0))
        name, image = _batch(cfg_j, 8)
        j_after, j_met = jax.jit(fns.train_step)(state, {name: image})
    cfg_t = _port_cfg(cfg_j)
    tfns = tstep.make_train_fns(cfg_t, device="cpu", dtype=torch.float32)
    ts = tfns.init_fn(cfg_t.train.seed)
    ts.model.load_state_dict(params_from_flax(_np_tree(state.params)),
                             strict=True)
    ts.d.load_state_dict(d_params_from_flax(_np_tree(state.d_params)),
                         strict=True)
    d0 = {k: v.clone() for k, v in ts.d.state_dict().items()}
    ts, t_met = tfns.train_step(
        ts, {name: torch.from_numpy(image)},
        noise=_jax_noise(cfg_j, state.rng, image.shape if name == "image"
                         else (8, *cfg_j.model.image_shape)))
    return (cfg_j, state, {k: float(v) for k, v in j_met.items()}, j_after,
            {k: float(v) for k, v in t_met.items()}, ts, d0)


@pytest.mark.parametrize("preset,objective", [
    ("mnist_advprior", "elbo"), ("cifar_advprior_resnet", "elbo"),
    ("cifar_advprior_resnet", "iwae")])
def test_biadversarial_r1_sn_step_matches_jax(preset, objective):
    """Metrics, both optimizers' first moments, and D's updated parameters
    after one biadversarial + R1 + SN step (the IWAE case: k=3, DReG, the
    pixel term on the k decoded means)."""
    extra = ({"train.objective": "iwae", "train.iwae_k": 3}
             if objective == "iwae" else {})
    cfg_j, s0, j_met, j_after, t_met, ts, d0 = _step_pair(preset, **extra)
    keys = KEYS | ({"iwae_bound"} if objective == "iwae" else set())
    assert set(t_met) == set(j_met) == keys
    for k in j_met:
        if k in ("d_acc", "px_d_acc"):
            # a fraction over 2·B logits: one logit across 0 moves it 1/16
            assert abs(t_met[k] - j_met[k]) <= 0.5 / 8 + 1e-7, k
        else:
            # f32 nets that agree to ~1e-5 relative; pixel sums of |recon|
            # up to ~2,000 nats; R1 a sum of squared input gradients
            np.testing.assert_allclose(t_met[k], j_met[k], rtol=1e-4,
                                       atol=1e-3, err_msg=k)
    assert j_met["d_r1"] > 0 and j_met["px_d_r1"] > 0
    # Adam's first moments: (1 − b1)·clip(g), scale-relative per tensor
    for module, mu, tree in (
            (ts.model, ts.opt.mu, params_from_flax(
                _np_tree(j_after.opt_state[1][0].mu))),
            (ts.d, ts.d_opt.mu, d_params_from_flax(
                _np_tree(j_after.d_opt_state[1][0].mu)))):
        got = dict(zip([n for n, _ in module.named_parameters()], mu))
        assert set(got) == set(tree)
        worst = max(_rel(got[k].numpy(), tree[k].numpy()) for k in tree)
        assert worst <= 1e-3, worst
    # D's step: where |g| stands above 1e-3 of the tensor's largest, the
    # update agrees to 1e-3 of lr; elsewhere both are steps of at most lr.
    # Each Δθ is read off f32 parameters: plus two ulps of the largest |θ|
    lr = cfg_j.adversarial.d_lr
    want_d = d_params_from_flax(_np_tree(j_after.d_params))
    mu_d = d_params_from_flax(_np_tree(j_after.d_opt_state[1][0].mu))
    got_d = ts.d.state_dict()
    for k, w in want_d.items():
        dw, dg = (w - d0[k]).numpy(), (got_d[k] - d0[k]).numpy()
        ulps = 2 * float(np.spacing(np.abs(d0[k].numpy()).max()))
        big = np.abs(mu_d[k].numpy()) > 1e-3 * np.abs(mu_d[k].numpy()).max()
        assert big.any()
        np.testing.assert_allclose(dg[big], dw[big], rtol=0,
                                   atol=1e-3 * lr + ulps, err_msg=k)
        assert np.abs(dg).max() <= lr + ulps


def test_d_reuse_off_decodes_x_hat_in_the_d_phase():
    """With ``d_reuse_posterior=False`` the D phase runs first, on its own
    posterior draw and its own decode of x̂ (ε of the D phase injected)."""
    over = {"train.batch_size": 8, "train.beta_warmup_steps": 0, **BIADV,
            "adversarial.d_reuse_posterior": False}
    cfg_j = tiny_config("mnist_advprior", **over)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "build_model", _flax_vae)
        mp.setattr(jstep, "PixelDiscriminator",
                   lambda widths: FlaxPixelD(widths, dtype=jnp.float32))
        fns = jstep.make_train_fns(cfg_j)
        state = fns.init_fn(jax.random.PRNGKey(0))
        name, image = _batch(cfg_j, 8)
        _, j_met = jax.jit(fns.train_step)(state, {name: image})
    cfg_t = _port_cfg(cfg_j)
    tfns = tstep.make_train_fns(cfg_t, device="cpu", dtype=torch.float32)
    ts = tfns.init_fn(0)
    ts.model.load_state_dict(params_from_flax(_np_tree(state.params)))
    ts.d.load_state_dict(d_params_from_flax(_np_tree(state.d_params)))
    z = cfg_j.model.z_dim
    _, k_g, k_d = jax.random.split(jax.random.fold_in(state.rng, 0), 3)
    k_post, k_prior = jax.random.split(k_d)
    noise = {"eps": _t(jax.random.normal(k_g, (8, z))),
             "d_eps": _t(jax.random.normal(k_post, (1, 8, z))),
             "z_p": _t(jax.random.normal(k_prior, (1, 8, z)))}
    _, t_met = tfns.train_step(ts, {name: torch.from_numpy(image)},
                               noise=noise)
    for k in ("d_loss", "px_d_loss", "d_r1", "px_d_r1", "loss", "g_px"):
        np.testing.assert_allclose(float(t_met[k]), float(j_met[k]),
                                   rtol=1e-4, atol=1e-3, err_msg=k)


# -- pixel_d_scores and the pixel_d OOD score ---------------------------------

def _pixel_pair(preset, **extra):
    cfg_j = tiny_config(preset, **BIADV, **extra)
    fpx = FlaxPixelD(tuple(cfg_j.adversarial.pixel_d_widths))
    h, w, c = cfg_j.model.image_shape
    params = fpx.init(jax.random.PRNGKey(4),
                      np.zeros((1, h, w, c), np.float32))["params"]
    params = jax.tree.map(lambda a: 4.0 * a + 0.01, params)
    tpx = PixelDiscriminator((h, w, c), tuple(
        cfg_j.adversarial.pixel_d_widths))
    sd = d_params_from_flax({"latent": {}, "pixel": _np_tree(params)})
    tpx.load_state_dict({k.removeprefix("pixel."): v for k, v in sd.items()
                         if k.startswith("pixel.")})
    return cfg_j, params, tpx


@pytest.mark.parametrize("preset", ["mnist_advprior", "cifar_advprior_resnet"])
def test_pixel_d_scores_match_jax(preset):
    """One bf16 D_x forward per test image in the target space: the same
    images, logits within the bf16 bar (3 bf16 conv layers: 3·2⁻⁸ of the
    logits' scale)."""
    cfg_j, params, tpx = _pixel_pair(preset)
    want = jeval.pixel_d_scores(cfg_j, params)
    cfg_t = _port_cfg(cfg_j)
    images = teval.eval_arrays(cfg_t, max_examples=cfg_t.ood.max_examples)
    got = teval.pixel_d_scores(cfg_t, tpx, images["image"], device="cpu")
    assert got.shape == want.shape == (cfg_j.ood.max_examples,)
    assert _rel(got, want) <= 3 * 2.0 ** -8


def test_pixel_d_ood_score_matches_jax():
    """ood.score=pixel_d: the AUROCs and means from the pixel D's logits,
    D passed as the biadversarial pair; a checkpoint that is not
    biadversarial raises the reference's ValueError."""
    cfg_j, params, tpx = _pixel_pair("mnist_advprior", **{
        "ood.score": "pixel_d", "ood.in_dataset": "mnist",
        "ood.ood_dataset": "fashion_mnist"})
    want = jood.ood_scores(cfg_j, None, {"latent": {}, "pixel": params})
    d = torch.nn.ModuleDict({"latent": torch.nn.Linear(1, 1), "pixel": tpx})
    got = tood.ood_scores(_port_cfg(cfg_j), None, d, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=
                                       2e-2 if "auroc" in k or "fpr" in k
                                       else 3 * 2.0 ** -8 * abs(v) + 1e-3,
                                       err_msg=k)
        else:
            assert got[k] == v
    plain = _port_cfg(tiny_config("mnist_advprior", **{
        "ood.score": "pixel_d"}))
    with pytest.raises(ValueError, match="biadversarial checkpoint"):
        tood.ood_scores(plain, None, torch.nn.Linear(1, 1), device="cpu")


def test_api_routes_the_latent_d(tmp_path):
    """A biadversarial checkpoint: ``api._d`` hands the latent D to the
    samplers and scorers, ``_load_named_model`` and ``ood_score`` keep the
    pair; the checkpoint round-trips both."""
    cfg = _port_cfg(tiny_config("mnist_advprior", tmp_dir=str(tmp_path),
                                **BIADV))
    state = tstep.make_train_fns(cfg, device="cpu").init_fn(0)
    save_checkpoint(tmp_path / cfg.name / "checkpoints", state, 0)
    (tmp_path / cfg.name / "config.json").write_text(
        json.dumps(json.loads(cfg.to_json())))
    restored = api._restore_state(cfg, device="cpu")
    assert set(restored.d) == {"latent", "pixel"}
    for a, b in zip(restored.d.state_dict().values(),
                    state.d.state_dict().values()):
        assert torch.equal(a, b)
    assert api._d(restored, cfg) is restored.d["latent"]
    _, _, d_b = api._load_named_model(cfg, cfg.name, device="cpu")
    assert set(d_b) == {"latent", "pixel"}
