"""The port's latent-space visualizer and ``api.visualize`` against
``apv_tpu``'s, and the eval-side entry points' reading of the EMA shadow.

``latent_scatter_data`` runs in both packages on the same converted
weights and images, the port handed the draws JAX makes from its keys
(the N(0, I) and ex-post draws, the SIR pool and pick, the MALA
proposals and accepts): the projections agree up to the sign of each PC
(an SVD's signs are free) and ``explained`` at 1e-6. Then the port alone:
the rasterized scatter's PNG, ``api.visualize`` and ``apv-torch sample
--visualize`` on a tiny checkpoint trained with an EMA shadow, which
``evaluate``, ``sample``, ``visualize``, ``ood_score`` and
``_load_named_model`` must read.
"""

import contextlib
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from apv_tpu.models import d_apply_fn
from apv_tpu.models.conv_vae import ConvVAE as FlaxConvVAE
from apv_tpu.models.discriminator import LatentDiscriminator as FlaxD
from apv_tpu.sampling import latent_viz as jviz
from apv_tpu_torch import api, cli
from apv_tpu_torch.convert import d_params_from_flax, params_from_flax
from apv_tpu_torch.models import LatentDiscriminator, build_model
from apv_tpu_torch.sampling import latent_viz as tviz
from apv_tpu_torch.utils import config as tcfg
from apv_tpu_torch.utils.png import decode_png

torch.set_num_threads(1)

N = 32
CASES = {
    "shaped": ("mnist_advprior", {}, 3),
    "flow": ("mnist_vae", {"model.prior": "flow",
                           "model.prior_flow_layers": 2,
                           "model.prior_flow_hidden": 8}, 0),
    "gaussian": ("mnist_vae", {"model.prior": "gaussian"}, 0),
}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _mala_draws(key, steps, n, z):
    """langevin_refine's per-step proposal normals and accept uniforms."""
    noise, unif = [], []
    for _ in range(steps):
        key, k_prop, k_acc = jax.random.split(key, 3)
        noise.append(jax.random.normal(k_prop, (n, z), jnp.float32))
        unif.append(jax.random.uniform(k_acc, (n,), jnp.float32))
    return _t(jnp.stack(noise)), _t(jnp.stack(unif))


def _jax_draws(key, n, z, d_apply, d_params, base_from, refine):
    """latent_scatter_data's keys (apv_tpu/sampling/latent_viz.py:44) and
    sample_prior's (run.py:137-149) replayed into the port's hooks."""
    k_p, k_s, k_e = jax.random.split(key, 3)
    draws = {"prior": _t(jax.random.normal(k_p, (n, z), jnp.float32)),
             "expost": _t(jax.random.normal(k_e, (n, z), jnp.float32))}
    if d_apply is not None:
        k_pool, k_sel, k_mala = jax.random.split(k_s, 3)
        pool = jax.random.normal(k_pool, (n * 16, z), jnp.float32)
        logw = d_apply(d_params, pool if base_from is None
                       else base_from(pool))
        draws.update(pool=_t(pool), pick=torch.from_numpy(np.array(
            jax.random.categorical(k_sel, logw, shape=(n,)))))
        if refine:
            draws["mala_noise"], draws["mala_uniforms"] = _mala_draws(
                k_mala, refine, n, z)
    return draws


@pytest.mark.parametrize("case", sorted(CASES))
def test_latent_scatter_data_matches_jax(case):
    """The shaped prior (SIR + 3 MALA steps through the latent D), the
    trained flow's and the trained Gaussian base's clouds beside the
    posterior, N(0, I) and ex-post clouds (tests/test_sampling.py:113,
    tests/test_flow_prior.py:234)."""
    preset, extra, refine = CASES[case]
    cfg = tiny_config(preset, **extra)
    m = cfg.model
    fmodel = FlaxConvVAE(z_dim=m.z_dim, widths=tuple(m.widths),
                         dense=m.dense, image_shape=tuple(m.image_shape),
                         prior=m.prior,
                         prior_flow_layers=m.prior_flow_layers,
                         prior_flow_hidden=m.prior_flow_hidden,
                         dtype=jnp.float32)
    x = (np.random.default_rng(3).random((N, 28, 28, 1)) < 0.4).astype(
        np.float32)
    params = fmodel.init(jax.random.PRNGKey(0), x[:2],
                         np.zeros((2, m.z_dim), np.float32))["params"]
    tree = lambda t: jax.tree.map(np.asarray, t)        # noqa: E731
    tmodel = build_model(tcfg.config_from_dict(json.loads(cfg.to_json()))
                         .model, dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(params_from_flax(tree(params)))
    d_apply = d_params = td = base_from = None
    if cfg.adversarial.enabled:
        fd = FlaxD(tuple(cfg.adversarial.d_widths))
        d_params = fd.init(jax.random.PRNGKey(1), np.zeros(
            (1, m.z_dim), np.float32))["params"]
        # a sharper D than its init, so the SIR weights are not flat
        d_params = jax.tree.map(lambda a: a * 3.0, d_params)
        d_apply = d_apply_fn(fd)
        td = LatentDiscriminator(m.z_dim, tuple(cfg.adversarial.d_widths))
        td.load_state_dict(d_params_from_flax(tree(d_params)))
    key = jax.random.PRNGKey(5)
    want = jviz.latent_scatter_data(fmodel, params, jnp.asarray(x), key,
                                    m.z_dim, d_apply=d_apply,
                                    d_params=d_params, refine_steps=refine)
    draws = _jax_draws(key, N, m.z_dim, d_apply, d_params, base_from,
                       refine)
    got = tviz.latent_scatter_data(tmodel, _t(x), m.z_dim, d=td,
                                   refine_steps=refine, model_prior=m.prior,
                                   draws=draws)
    assert set(got) == set(want)
    assert abs(got["explained"] - want["explained"]) <= 1e-6
    # each PC's sign is free: read it off the posterior cloud
    sign = np.sign(np.sum(got["posterior"] * np.asarray(
        want["posterior"]), axis=0))
    for k in set(want) - {"explained"}:
        w = np.asarray(want[k], np.float64)
        assert got[k].shape == w.shape == (N, 2), k
        # f32 conv nets agreeing to ~1e-5 relative, projected in float64
        np.testing.assert_allclose(got[k] * sign, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
    np.testing.assert_allclose(got["posterior"].mean(0), 0.0, atol=1e-9)


def test_scatter_png_decodes_to_its_size(tmp_path):
    """The rasterized scatter: a [512, 512, 3] PNG, white where no cloud
    is, each cloud's colour where its points are."""
    rng = np.random.default_rng(0)
    data = {"posterior": rng.normal(size=(300, 2)),
            "prior": rng.normal(size=(300, 2)) * 2,
            "shaped_prior": rng.normal(size=(300, 2)) + 3,
            "expost_prior": rng.normal(size=(300, 2)), "explained": 0.5}
    path = tviz.save_latent_scatter(data, tmp_path / "s" / "scatter.png")
    img = decode_png(path.read_bytes())
    assert img.shape == (512, 512, 3) and img.dtype == np.uint8
    assert np.array_equal(img, tviz.scatter_image(data))
    assert (img == 255).all(axis=-1).mean() > 0.3
    red = (img[..., 0] > 200) & (img[..., 1] < 150)
    assert red.any() and img.std() > 10


# -- the port alone: api.visualize and the shadow on a tiny checkpoint --------

TINY = ["model.z_dim=8", "model.widths=[8,16]", "model.blocks_per_stage=1",
        "adversarial.d_widths=[32,32]", "train.batch_size=16",
        "train.steps=4", "train.steps_per_call=1", "train.eval_every=0",
        "train.checkpoint_every=4", "data.synthetic_size=256",
        "train.ema_decay=0.5", "train.lr=1e-2"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny cifar_advprior_resnet checkpoint with an EMA shadow."""
    from apv_tpu_torch import train_loop
    tmp = str(tmp_path_factory.mktemp("viz_run"))
    cfg = tcfg.apply_overrides(tcfg.get_preset("cifar_advprior_resnet"),
                               TINY + [f"results_dir={tmp}"])
    with contextlib.redirect_stdout(io.StringIO()):
        train_loop(cfg, device="cpu")
    saved = torch.load(Path(tmp) / cfg.name / "checkpoints"
                       / "step_000000004.pt", weights_only=True)
    return tmp, cfg, saved


@pytest.mark.parametrize("what,n,shape", [
    ("reconstruct", 4, (2 * 34 - 2, 4 * 34 - 2, 3)),
    ("interpolate", 3, (3 * 34 - 2, 5 * 34 - 2, 3)),
    ("latent", 8, (512, 512, 3))])
def test_visualize_writes_its_png(trained, what, n, shape):
    """reconstruct: the n originals over their reconstructions;
    interpolate: n rows of 5 slerp steps; latent: the scatter of at least
    256 posterior means (SIR + 2 MALA steps); each PNG not constant."""
    tmp, cfg, _ = trained
    out = api.visualize("cifar_advprior_resnet",
                        overrides=[f"results_dir={tmp}"], what=what, n=n,
                        steps=5, refine=2 if what == "latent" else 0,
                        device="cpu")
    name = {"reconstruct": "reconstructions.png",
            "interpolate": "interpolation.png",
            "latent": "latent_scatter.png"}[what]
    img = decode_png((Path(tmp) / cfg.name / name).read_bytes())
    assert img.shape == shape and img.std() > 1.0
    if what == "latent":
        assert out["posterior"].shape == (256, 2)
        assert set(out) >= {"shaped_prior", "prior", "expost_prior"}
    elif what == "interpolate":
        assert tuple(out.shape) == (3, 5, 32, 32, 3)
    else:
        assert tuple(out.shape) == (4, 32, 32, 3)


def test_visualize_refusals(trained, tmp_path):
    tmp, _, _ = trained
    over = [f"results_dir={tmp}"]
    with pytest.raises(ValueError, match="unknown visualization"):
        api.visualize("cifar_advprior_resnet", overrides=over, what="pca",
                      device="cpu")
    with pytest.raises(ValueError, match="interpolate needs"):
        api.visualize("cifar_advprior_resnet", overrides=over,
                      what="interpolate", n=200, device="cpu")
    with pytest.raises(ValueError, match="no latent discriminator"):
        api.visualize("cifar_advprior_resnet", overrides=over + [
            "adversarial.enabled=false"], what="latent", refine=2,
            device="cpu")


def test_cli_sample_visualize_latent(trained, tmp_path):
    """``apv-torch sample --visualize latent --device cpu`` writes the
    scatter where --out says."""
    tmp, _, _ = trained
    out = tmp_path / "cli_scatter.png"
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        code = cli.main(["sample", "--preset", "cifar_advprior_resnet",
                         "--set", f"results_dir={tmp}", "--visualize",
                         "latent", "-n", "4", "--refine", "1", "--out",
                         str(out), "--device", "cpu"])
    assert code == 0 and "wrote latent grid" in printed.getvalue()
    assert decode_png(out.read_bytes()).shape == (512, 512, 3)


def _same(module, sd) -> bool:
    mine = module.state_dict()
    return all(torch.equal(mine[k], sd[k]) for k in sd)


@pytest.mark.parametrize("entry", ["evaluate", "sample", "visualize",
                                   "ood_score", "load_named_model"])
def test_eval_side_entry_points_read_the_shadow(trained, entry,
                                                monkeypatch):
    """Each eval-side entry point hands its evaluator the checkpoint's EMA
    shadow, not its raw parameters (apv_tpu/api.py:96-100); under
    ema_decay=0 the raw parameters."""
    from apv_tpu_torch.eval import ood, run as erun
    from apv_tpu_torch.sampling import run as srun
    tmp, cfg, saved = trained
    assert not _same_sd(saved["ema_model"], saved["model"])
    seen = []

    def grab(ret):
        def fn(*args, **kw):
            seen.append(next(a for a in args if isinstance(
                a, torch.nn.Module) and hasattr(a, "encode")))
            return ret
        return fn

    over = [f"results_dir={tmp}"]
    if entry == "evaluate":
        monkeypatch.setattr(erun, "evaluate_nll", grab({"bits_per_dim": 1.0}))
        monkeypatch.setattr(erun, "posterior_activity", grab({}))
        api.evaluate("iwae_eval", overrides=over, device="cpu")
    elif entry == "sample":
        monkeypatch.setattr(srun, "generate_samples", grab(
            (torch.zeros(2, 32, 32, 3), {})))
        monkeypatch.setattr(srun, "save_image_grid", lambda *a, **k: None)
        api.sample("cifar_advprior_resnet", overrides=over, n=2,
                   device="cpu")
    elif entry == "visualize":
        monkeypatch.setattr(srun, "reconstruct_images", grab(
            torch.zeros(2, 32, 32, 3)))
        monkeypatch.setattr(srun, "save_image_grid", lambda *a, **k: None)
        api.visualize("cifar_advprior_resnet", overrides=over, n=2,
                      device="cpu")
    elif entry == "ood_score":
        monkeypatch.setattr(ood, "ood_scores", grab({}))
        monkeypatch.setattr(api, "_write_json", lambda *a, **k: None)
        api.ood_score("ood_suite", overrides=over, device="cpu")
    else:
        _, model, _ = api._load_named_model(
            tcfg.apply_overrides(cfg, over), cfg.name, device="cpu")
        seen.append(model)
    assert len(seen) >= 1
    assert all(_same(m, saved["ema_model"]) for m in seen)
    # the same checkpoint read under ema_decay=0: the raw parameters
    off = tcfg.apply_overrides(cfg, over + ["train.ema_decay=0"])
    state = api._restore_state(off, device="cpu")
    assert state.ema_model is None and _same(api._p(state, off),
                                             saved["model"])


def _same_sd(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)
