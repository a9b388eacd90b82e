"""The port's front door: ``api.train``, ``api.evaluate`` (with the ex-post
priors and ``posterior_activity``), ``api.info``, the Ctrl-C checkpoint,
the profiler window and the ``apv-torch`` CLI.

``api.evaluate`` runs on a tiny port checkpoint built from converted flax
weights (float32 on both sides) and is held to ``apv_tpu``'s
``evaluate_nll(prior_moments=)`` with the reference's own ex-post fit on the
train split: the port gets JAX's chunk noise, log-Z draws and GMM draws.
Tolerances as in ``tests/test_torch_priors.py``: per-sample scores 2e-5
relative (f32 sums over 3,072 pixels), log Z 1e-5, the fitted moments
1e-5 relative, the GMM 1e-4.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from apv_tpu import api as japi
from apv_tpu.eval import run as jeval
from apv_tpu.models.discriminator import LatentDiscriminator as FlaxD
from apv_tpu.models.resnet_vae import ResNetVAE as FlaxVAE
from apv_tpu.ops import dispatch as jdispatch
from apv_tpu_torch import api, cli
from apv_tpu_torch.convert import d_params_from_flax, params_from_flax
from apv_tpu_torch.eval import iwae_eval as tiwae
from apv_tpu_torch.eval import run as teval
from apv_tpu_torch.sampling import run as trun
from apv_tpu_torch.training import loop as tloop
from apv_tpu_torch.training import step as tstep
from apv_tpu_torch.utils import checkpoint as ckpt
from apv_tpu_torch.utils.config import apply_overrides, config_from_dict

torch.set_num_threads(1)

Z = 8
TINY = ["model.z_dim=8", "model.widths=[8,16]", "model.blocks_per_stage=1",
        "adversarial.d_widths=[32,32]", "train.batch_size=16",
        "train.steps=6", "train.steps_per_call=1", "train.eval_every=0",
        "train.checkpoint_every=100", "train.log_every=1",
        "data.synthetic_size=96"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _port_cfg(cfg_j):
    return config_from_dict(json.loads(cfg_j.to_json()))


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


# -- api.evaluate and posterior_activity against the reference ---------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(cfg_j, flax model, params, d_params, results dir): a tiny float32
    flagship with a 3×-scaled D, saved as a port checkpoint of the
    training preset's name with its config.json."""
    tmp = tmp_path_factory.mktemp("eval_run")
    cfg_j = tiny_config("iwae_eval", tmp_dir=str(tmp), **{
        "eval.iwae_k": 4, "eval.iwae_chunk": 2, "eval.batch_size": 8,
        "eval.max_examples": 16})
    m = cfg_j.model
    fmodel = FlaxVAE(z_dim=m.z_dim, widths=tuple(m.widths),
                     blocks_per_stage=m.blocks_per_stage,
                     image_shape=tuple(m.image_shape), upsample=m.upsample,
                     activation=m.activation, norm=m.norm, dtype=jnp.float32)
    params = fmodel.init(jax.random.PRNGKey(0),
                         np.zeros((1, 32, 32, 3), np.float32),
                         np.zeros((1, Z), np.float32))["params"]
    d_params = jax.tree.map(lambda a: 3.0 * a, FlaxD((32, 32)).init(
        jax.random.PRNGKey(1), np.zeros((1, Z), np.float32))["params"])
    train_cfg = dataclasses.replace(_port_cfg(cfg_j),
                                    name="cifar_advprior_resnet",
                                    checkpoint_of=None)
    state = tstep.make_train_fns(train_cfg, device="cpu").init_fn(0)
    state.model.load_state_dict(params_from_flax(_np_tree(params)))
    state.d.load_state_dict(d_params_from_flax(_np_tree(d_params)))
    run = tmp / "cifar_advprior_resnet"
    ckpt.save_checkpoint(run / "checkpoints", state, 6)
    (run / "config.json").write_text(train_cfg.to_json())
    return cfg_j, fmodel, params, d_params, tmp


def _jax_gmm_injected(seed, draws=2):
    """``trun.expost_prior_gmm`` handed the draws of the reference's
    ``expost_prior_gmm(..., PRNGKey(seed))``."""
    real = trun.expost_prior_gmm

    def fit(model, x_in, *, k=10, generator=None, **kw):
        k_draw, k_fit = jax.random.split(jax.random.PRNGKey(seed))
        eps = jnp.stack([jax.random.normal(kk, (len(x_in), Z), jnp.float32)
                         for kk in jax.random.split(k_draw, draws)])
        first = int(jax.random.randint(k_fit, (), 0, draws * len(x_in)))
        return real(model, x_in, k=k, eps=_t(eps), first=first, **kw)

    return fit


@pytest.mark.parametrize("prior", ["model", "expost", "expost_gmm"])
def test_api_evaluate_matches_reference(pair, prior):
    """api.evaluate on the port checkpoint against the reference's
    evaluate_nll(prior_moments=) with its _expost_prior(split='train') on
    the same weights: per-sample scores, log Z, the "prior" field, the
    active units; eval.json or eval_<prior>.json written without
    per_sample."""
    cfg_j, fmodel, params, d_params, tmp = pair
    with jdispatch.backend("jnp"):
        pm_j = japi._expost_prior(cfg_j, fmodel, params, prior, gmm_k=2,
                                  split="train")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jeval, "build_model", lambda mc: fmodel)
            want = jeval.evaluate_nll(cfg_j, params, d_params, per_sample=True,
                                      prior_moments=pm_j)
            act_j = jeval.posterior_activity(cfg_j, params)

    chunks = iter([_t(jax.random.normal(kk, (2, 8, Z)))
                   for i in range(2)
                   for kk in jax.random.split(jax.random.PRNGKey(i), 2)])
    log_z_draws = torch.stack([
        _t(jax.random.normal(kk, (5000, Z)))
        for kk in jax.random.split(jax.random.PRNGKey(17), 20)])
    real_lp = teval.estimate_log_partition
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstep, "make_train_fns", functools.partial(
            tstep.make_train_fns, dtype=torch.float32))
        mp.setattr(tiwae, "sample_posterior_chunk",
                   lambda mean, logvar, n, **kw: tiwae.ops.reparam_sample(
                       mean, logvar, n, eps=next(chunks)))
        mp.setattr(teval, "estimate_log_partition",
                   lambda *a, **kw: real_lp(*a, draws=log_z_draws, **kw))
        mp.setattr(trun, "expost_prior_gmm", _jax_gmm_injected(0))
        got = api.evaluate("iwae_eval", overrides=[
            f"results_dir={tmp}", "eval.iwae_k=4", "eval.iwae_chunk=2",
            "eval.batch_size=8", "eval.max_examples=16"], per_sample=True,
            prior=prior, gmm_k=2, device="cpu")
    assert got["prior"] == want["prior"] == prior
    assert got["adversarial_prior"] == want["adversarial_prior"] == (
        prior == "model")
    np.testing.assert_allclose(got["log_partition"], want["log_partition"],
                               rtol=1e-5, atol=1e-5)
    if prior != "model":
        assert got["log_partition"] == got["log_partition_se"] == 0.0
    np.testing.assert_allclose(got["per_sample"], want["per_sample"],
                               rtol=2e-5, atol=1e-2)
    assert got["active_units"] == act_j["active_units"]
    np.testing.assert_allclose(got["max_unit_variance"],
                               act_j["max_unit_variance"], rtol=1e-4)
    name = "eval.json" if prior == "model" else f"eval_{prior}.json"
    saved = json.loads((tmp / "iwae_eval" / name).read_text())
    assert "per_sample" not in saved and saved["prior"] == prior


def test_expost_fit_reads_the_binarized_train_split(pair):
    """The NLL path's ex-post Gaussian is fitted on the train split (the
    test split stays sample's), the same moments as the reference's; on
    MNIST the train split binarized with train.seed."""
    cfg_j, fmodel, params, _, _ = pair
    cfg_t = _port_cfg(cfg_j)
    tstate = tstep.make_train_fns(cfg_t, device="cpu",
                                  dtype=torch.float32).init_fn(0)
    tstate.model.load_state_dict(params_from_flax(_np_tree(params)))
    for split in ("train", "test"):
        want = japi._expost_prior(cfg_j, fmodel, params, "expost",
                                  split=split)
        got = api._expost_prior(cfg_t, tstate.model, "expost", split=split,
                                device="cpu")
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)
    mn = tiny_config("mnist_vae")
    seen = {}
    real = teval._prep_eval_batch

    def spy(cfg, image):
        seen["image"] = image
        return real(cfg, image)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(teval, "_prep_eval_batch", spy)
        model = tstep.make_train_fns(_port_cfg(mn), device="cpu").init_fn(
            0).model
        api._expost_prior(_port_cfg(mn), model, "expost", split="train",
                          device="cpu")
    from apv_tpu.data import load_dataset, static_binarize
    raw, _ = load_dataset("mnist", "train", synthetic_size=256)
    np.testing.assert_array_equal(
        seen["image"], static_binarize(raw, seed=mn.train.seed)[:2048])


def test_posterior_activity_matches_reference(pair):
    cfg_j, fmodel, params, _, _ = pair
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeval, "build_model", lambda mc: fmodel)
        want = jeval.posterior_activity(cfg_j, params, threshold=1e-3)
    cfg_t = _port_cfg(cfg_j)
    model = tstep.make_train_fns(cfg_t, device="cpu",
                                 dtype=torch.float32).init_fn(0).model
    model.load_state_dict(params_from_flax(_np_tree(params)))
    images = teval.eval_arrays(cfg_t, max_examples=16)["image"]
    got = teval.posterior_activity(cfg_t, model, images, threshold=1e-3,
                                   device="cpu")
    assert set(got) == set(want)
    assert got["active_units"] == want["active_units"]
    assert got["z_dim"] == want["z_dim"] == Z
    for k in ("max_unit_variance", "median_unit_variance"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_evaluate_nll_prior_moments_refusals():
    cfg = _port_cfg(tiny_config("cifar_advprior_resnet"))
    pm = (torch.zeros(Z), torch.ones(Z))
    images = np.zeros((4, 32, 32, 3), np.uint8)
    with pytest.raises(ValueError, match="mutually exclusive"):
        teval.evaluate_nll(cfg, None, None, images, prior_moments=pm,
                           use_adversarial_prior=True, device="cpu")
    with pytest.raises(ValueError, match="excludes"):
        tiwae.make_logw_chunk_fn(None, "bernoulli", 2, d_apply=lambda z: z,
                                 prior_logpdf=lambda z: z)
    with pytest.raises(ValueError, match="unknown prior"):
        api.evaluate("iwae_eval", prior="flow", device="cpu")


# -- api.train, resume, overwrite, Ctrl-C, the trace window ------------------

def _train_over(tmp, *extra):
    return TINY + [f"results_dir={tmp}", *extra]


def _spy_cfgs(mp):
    """Record each cfg the loop builds its train step from."""
    cfgs, real = [], tloop.make_train_fns

    def spy(cfg, **kw):
        cfgs.append(cfg)
        return real(cfg, **kw)

    mp.setattr(tloop, "make_train_fns", spy)
    return cfgs


def test_api_train_fresh_resume_overwrite(tmp_path):
    """A fresh run, a resume that continues its checkpoint with the
    overrides re-applied, the refusal of a fresh run into a used dir, and
    overwrite."""
    over = _train_over(tmp_path)
    state = _quiet(api.train, "cifar_advprior_resnet", overrides=over,
                   max_steps=2, device="cpu")
    assert state.step == 2
    run = tmp_path / "cifar_advprior_resnet"
    assert ckpt.latest_step(run / "checkpoints") == 2
    with pytest.MonkeyPatch.context() as mp:
        cfgs = _spy_cfgs(mp)
        state = _quiet(api.train, "cifar_advprior_resnet",
                       overrides=over + ["train.lr=1e-3"], resume=True,
                       max_steps=2, device="cpu")
    assert state.step == 4 and cfgs[-1].train.lr == 1e-3
    with pytest.raises(FileExistsError, match="already holds a run"):
        _quiet(api.train, "cifar_advprior_resnet", overrides=over,
               max_steps=1, device="cpu")
    state = _quiet(api.train, "cifar_advprior_resnet", overrides=over,
                   max_steps=1, overwrite=True, device="cpu")
    assert state.step == 1 and ckpt.latest_step(run / "checkpoints") == 1


def test_resume_adopts_the_architecture_only_with_a_checkpoint(tmp_path):
    """A results dir holding only a crashed run's config.json (no
    checkpoint) leaves the preset as it is; with a checkpoint, the saved
    model section replaces the preset's (an activation carries no
    weights, so the checkpoint loads either way)."""
    over = _train_over(tmp_path)
    run = tmp_path / "cifar_advprior_resnet"
    run.mkdir()
    saved = apply_overrides(api._resolve("cifar_advprior_resnet", over),
                            ["model.activation=relu"])
    (run / "config.json").write_text(saved.to_json())
    with pytest.MonkeyPatch.context() as mp:
        cfgs = _spy_cfgs(mp)
        _quiet(api.train, "cifar_advprior_resnet", overrides=over,
               resume=True, max_steps=1, device="cpu")
        assert cfgs[-1].model.activation != "relu"
        (run / "config.json").write_text(saved.to_json())
        _quiet(api.train, "cifar_advprior_resnet", overrides=over,
               resume=True, max_steps=1, device="cpu")
        assert cfgs[-1].model.activation == "relu"


def _same_state(a, b) -> bool:
    def flat(x, out):
        if isinstance(x, dict):
            for k in sorted(x):
                flat(x[k], out)
        elif isinstance(x, (list, tuple)):
            for v in x:
                flat(v, out)
        else:
            out.append(x)
        return out
    fa, fb = flat(a.state_dict(), []), flat(b.state_dict(), [])
    return len(fa) == len(fb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(fa, fb))


def _interrupting(step_at, signals=0, raise_=False):
    """make_train_fns whose train step, about to take step ``step_at``,
    sends itself ``signals`` SIGINTs, or raises KeyboardInterrupt."""
    real = tstep.make_train_fns

    def make(cfg, **kw):
        fns = real(cfg, **kw)

        def step(state, batch, **k):
            if state.step == step_at:
                for _ in range(signals):
                    os.kill(os.getpid(), signal.SIGINT)
                if raise_:
                    raise KeyboardInterrupt
            return fns.train_step(state, batch, **k)

        return fns._replace(train_step=step)
    return make


def _interrupted(mp, over, make) -> str:
    """Run api.train (resume=True) under ``make``; it must raise
    KeyboardInterrupt. Returns what it printed."""
    out = io.StringIO()
    mp.setattr(tloop, "make_train_fns", make)
    with contextlib.redirect_stdout(out), pytest.raises(KeyboardInterrupt):
        api.train("cifar_advprior_resnet", overrides=over, resume=True,
                  device="cpu")
    return out.getvalue()


K2 = "train.steps_per_call=2"


def test_ctrl_c_saves_a_checkpoint_and_resume_is_bit_equal(tmp_path):
    """In calls of 2 steps, a SIGINT inside a call's second step (step 1)
    and one inside a call's first step (step 2) are each held to the end
    of that call: a checkpoint at step 2, then at step 4, and the run
    re-raises; resuming to step 6 gives the state of an uninterrupted
    6-step run, bit for bit."""
    full = _quiet(api.train, "cifar_advprior_resnet",
                  overrides=_train_over(tmp_path / "full", K2), device="cpu")
    assert full.step == 6
    over = _train_over(tmp_path / "cut", K2)
    ckpts = tmp_path / "cut" / "cifar_advprior_resnet" / "checkpoints"
    for at, saved in ((1, 2), (2, 4)):
        with pytest.MonkeyPatch.context() as mp:
            out = _interrupted(mp, over, _interrupting(at, signals=1))
        assert f"interrupted at step {saved}; checkpoint saved" in out
        assert ckpt.latest_step(ckpts) == saved
    resumed = _quiet(api.train, "cifar_advprior_resnet", overrides=over,
                     resume=True, device="cpu")
    assert resumed.step == 6 and _same_state(resumed, full)


def test_ctrl_c_twice_or_from_inside_a_step_saves_nothing(tmp_path):
    """A second SIGINT raises at once, and a KeyboardInterrupt may come
    from inside a step: either can leave a step half-applied, so neither
    saves; the checkpoint of step 2 stays the newest."""
    over = _train_over(tmp_path, K2)
    ckpts = tmp_path / "cifar_advprior_resnet" / "checkpoints"
    _quiet(api.train, "cifar_advprior_resnet", overrides=over, max_steps=2,
           device="cpu")
    for make in (_interrupting(3, signals=2), _interrupting(3, raise_=True),
                 _interrupting(2, raise_=True)):
        with pytest.MonkeyPatch.context() as mp:
            out = _interrupted(mp, over, make)
        assert "nothing saved, --resume continues from step 2" in out
        assert ckpt.latest_step(ckpts) == 2


def test_ctrl_c_during_the_last_save_still_stops(tmp_path):
    """A SIGINT that lands while the last call's checkpoint is written is
    not dropped: the run re-raises after it, with the step-6 checkpoint
    written once."""
    over = _train_over(tmp_path, K2)
    real, saves = ckpt.save_checkpoint, []

    def save(ckpt_dir, state, step, **kw):
        saves.append(step)
        if step == 6:
            os.kill(os.getpid(), signal.SIGINT)
        return real(ckpt_dir, state, step, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ckpt, "save_checkpoint", save)
        out = _interrupted(mp, over, tstep.make_train_fns)
    assert "interrupted at step 6; checkpoint saved" in out
    assert saves == [6] and ckpt.latest_step(
        tmp_path / "cifar_advprior_resnet" / "checkpoints") == 6


def test_trace_window_counts_from_the_runs_first_step(tmp_path):
    """The profiler window covers steps 10-15 of this invocation: a run
    resumed at step 4 traces its steps 14-19, written as a Chrome trace
    named by those absolute steps; a run that ends inside the window
    writes it in close()."""
    from apv_tpu_torch.utils.logging import MetricLogger
    seen = []
    lg = MetricLogger(tmp_path, trace_dir=tmp_path / "tr", trace_offset=4)
    assert lg.trace_steps == (14, 19)
    for step in range(4, 22):
        lg.maybe_trace(step)
        seen.append(lg._prof is not None)
    assert [s for s, on in zip(range(4, 22), seen) if on] == list(
        range(14, 19))
    trace = tmp_path / "tr" / "trace_steps_14-19.json"
    assert json.loads(trace.read_text())["traceEvents"] is not None
    # calls of 8 from step 0: the call holding step 10 starts it, the first
    # call past 15 stops it; a run that stops inside it writes in close()
    lg = MetricLogger(tmp_path, trace_dir=tmp_path / "tr8")
    lg.maybe_trace(0, 8)
    assert lg._prof is None
    lg.maybe_trace(8, 8)
    assert lg._prof is not None
    lg.close()
    assert (tmp_path / "tr8" / "trace_steps_10-15.json").exists()


def test_train_loop_writes_the_trace(tmp_path):
    over = _train_over(tmp_path, "train.steps=12")
    _quiet(api.train, "cifar_advprior_resnet", overrides=over,
           max_steps=12, trace_dir=str(tmp_path / "trace"), device="cpu")
    trace = tmp_path / "trace" / "trace_steps_10-15.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("reparam" in e.get("name", "") or "conv" in e.get("name", "")
               for e in events)


# -- api.info ----------------------------------------------------------------

def test_info_on_a_port_run_and_a_double_encoded_config(tmp_path):
    """info lists runs and one run's steps, best, result files and last
    metrics from the files alone; the legacy double-encoded config.json
    reads as the plain one, through _saved_config too. No CUDA is
    initialized."""
    over = _train_over(tmp_path, "train.checkpoint_every=2")
    _quiet(api.train, "cifar_advprior_resnet", overrides=over, max_steps=4,
           device="cpu")
    run = tmp_path / "cifar_advprior_resnet"
    (run / "eval.json").write_text(json.dumps({"bits_per_dim": 7.5}))
    (run / "eval_expost.json").write_text(json.dumps({"bits_per_dim": 7.4}))
    listing = api.info(results_dir=str(tmp_path))
    assert [r["name"] for r in listing["runs"]] == ["cifar_advprior_resnet"]
    one = api.info("cifar_advprior_resnet", results_dir=str(tmp_path))
    assert one["checkpoint_steps"] == [2, 4]
    assert one["latest_checkpoint"] == 4
    assert one["adversarial"] == "learned_prior" and one["z_dim"] == Z
    assert one["eval"] == {"bits_per_dim": 7.5}
    assert one["eval_expost"] == {"bits_per_dim": 7.4}
    assert one["last_metrics"]["step"] == 3
    plain = json.loads((run / "config.json").read_text())
    (run / "config.json").write_text(json.dumps(json.dumps(plain)))
    again = api.info("cifar_advprior_resnet", results_dir=str(tmp_path))
    assert again["dataset"] == one["dataset"] == "cifar10"
    cfg = api._resolve("cifar_advprior_resnet", over)
    assert api._saved_config(cfg).to_json() == config_from_dict(
        plain).to_json()
    with pytest.raises(FileNotFoundError, match="no run named"):
        api.info("missing", results_dir=str(tmp_path))
    assert not torch.cuda.is_initialized()


# -- the CLI ------------------------------------------------------------------

def test_cli_parses_the_reference_flags():
    p = cli._parser()
    a = p.parse_args(["train", "--preset", "cifar_advprior_resnet", "--set",
                      "train.lr=1e-4", "--set", "name=x", "--resume",
                      "--max-steps", "5", "--trace-dir", "t"])
    assert (a.preset, a.overrides, a.resume, a.max_steps, a.trace_dir,
            a.device) == ("cifar_advprior_resnet",
                          ["train.lr=1e-4", "name=x"], True, 5, "t", "cuda")
    a = p.parse_args(["evaluate", "--prior", "expost_gmm", "--gmm-k", "3",
                      "--k", "100", "--device", "cpu"])
    assert (a.preset, a.prior, a.gmm_k, a.k, a.device) == (
        "iwae_eval", "expost_gmm", 3, 100, "cpu")
    a = p.parse_args(["sample", "-n", "9", "--prior", "expost_flow",
                      "--temperature", "0.7", "--refine", "2"])
    assert (a.n, a.prior, a.temperature, a.refine) == (9, "expost_flow",
                                                       0.7, 2)
    a = p.parse_args(["ood", "--both", "--seed", "3"])
    assert (a.preset, a.both, a.seed) == ("ood_suite", True, 3)
    a = p.parse_args(["info", "run", "--results-dir", "r"])
    assert (a.name, a.results_dir) == ("run", "r")
    with pytest.raises(SystemExit):
        p.parse_args(["train", "--platform", "tpu"])


def test_cli_refuses_unknown_flags():
    """Every command parses its flags strictly, export's included."""
    with pytest.raises(SystemExit) as e:
        cli.main(["train", "--steps", "4"])
    assert e.value.code == 2


@pytest.mark.parametrize("argv,match", [
    (["sample", "--visualize", "latent", "--prior", "expost"],
     "--prior apply to prior sampling"),
    (["sample", "--visualize", "latent", "--temperature", "0.8"],
     "--temperature apply to prior sampling"),
    (["export", "--what", "scorer", "--temperature", "0.8"],
     "temperature is sampler-only"),
    # item 13 is ported: --distributed without APV_COORDINATOR is refused
    # as the reference refuses it (the id kept from the refusal it had)
    pytest.param(["train", "--distributed"],
                 "--distributed set but APV_COORDINATOR unset",
                 id="argv3-item 13"),
    (["train", "--checkpoint-dir", "x"], "eval-side only")])
def test_cli_refuses_what_the_port_lacks(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)


def test_cli_runs_train_evaluate_info_presets_on_the_cpu(tmp_path, capsys):
    """The CLI end to end with --device cpu: train, evaluate under an
    ex-post prior, info and presets."""
    over = ["--set", f"results_dir={tmp_path}"]
    for o in TINY:
        over += ["--set", o]
    assert cli.main(["train", "--preset", "cifar_advprior_resnet",
                     "--max-steps", "2", "--device", "cpu", *over]) == 0
    assert "trained to step 2" in capsys.readouterr().out
    ev = ["--set", "eval.iwae_k=2", "--set", "eval.iwae_chunk=2", "--set",
          "eval.max_examples=8", "--set", "eval.batch_size=8"]
    assert cli.main(["evaluate", "--prior", "expost", "--device", "cpu",
                     *over, *ev]) == 0
    out = capsys.readouterr().out
    res = json.loads(out[out.index("{"):])
    assert res["prior"] == "expost" and np.isfinite(res["bits_per_dim"])
    assert (tmp_path / "iwae_eval" / "eval_expost.json").exists()
    assert cli.main(["info", "--results-dir", str(tmp_path)]) == 0
    assert "cifar_advprior_resnet" in capsys.readouterr().out
    assert cli.main(["presets"]) == 0
    assert "iwae_eval" in capsys.readouterr().out
    assert not torch.cuda.is_initialized()


def test_cli_sample_ood_and_each_ex_post_prior_on_the_cpu(tmp_path, capsys):
    """The rest of the CLI on a tiny port run: sample (a grid), ood (both
    directions, ood.json), evaluate under the ex-post GMM and flow."""
    over = ["--set", f"results_dir={tmp_path}"]
    for o in TINY:
        over += ["--set", o]
    assert cli.main(["train", "--preset", "cifar_advprior_resnet",
                     "--max-steps", "2", "--device", "cpu", *over]) == 0
    assert cli.main(["sample", "--preset", "cifar_advprior_resnet", "-n",
                     "4", "--device", "cpu", *over]) == 0
    assert (tmp_path / "cifar_advprior_resnet" / "samples.png").exists()
    assert cli.main(["ood", "--both", "--device", "cpu", *over, "--set",
                     "ood.max_examples=8", "--set", "ood.batch_size=8",
                     "--set", "ood.iwae_k=2", "--set",
                     "ood.iwae_chunk=2"]) == 0
    assert json.loads((tmp_path / "ood_suite" / "ood.json").read_text())[
        "reverse_model"] == "shared"
    ev = ["--set", "eval.iwae_k=2", "--set", "eval.iwae_chunk=2", "--set",
          "eval.max_examples=8", "--set", "eval.batch_size=8"]
    for prior, extra in (("expost_gmm", ["--gmm-k", "2"]),
                         ("expost_flow", ["--flow-steps", "3"])):
        capsys.readouterr()
        assert cli.main(["evaluate", "--prior", prior, "--device", "cpu",
                         *extra, *over, *ev]) == 0
        saved = json.loads((tmp_path / "iwae_eval"
                            / f"eval_{prior}.json").read_text())
        assert saved["prior"] == prior and np.isfinite(
            saved["bits_per_dim"])


def test_front_door_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="none is available"):
        api.train("mnist_vae", overrides=[f"results_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="none is available"):
        api.evaluate("iwae_eval", overrides=[f"results_dir={tmp_path}"])
