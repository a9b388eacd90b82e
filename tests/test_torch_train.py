"""The port's train step, optimizers and loop against ``apv_tpu``'s.

One ``mnist_advprior`` step at ``tiny_config`` size runs through
``apv_tpu.training.step.make_train_fns`` (jitted once for the module, its
model built in float32 by patching ``step.build_model`` here) and through
the port's ``make_train_fns`` on the CPU, from the same converted weights
and the same noise: the port is handed the ε and z_p that JAX draws,
re-derived with JAX's own key splits.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import tiny_config
from apv_tpu.data.preprocess import pack_bits
from apv_tpu.models.conv_vae import ConvVAE as FlaxConvVAE
from apv_tpu.training import losses as jlosses
from apv_tpu.training import step as jstep
from apv_tpu_torch.convert import d_params_from_flax, params_from_flax
from apv_tpu_torch.training import losses as tlosses
from apv_tpu_torch.training import step as tstep
from apv_tpu_torch.training.loop import train_loop
from apv_tpu_torch.utils.config import config_from_dict

torch.set_num_threads(1)

N_STEPS = 3
# beta warm-up over 2 steps: β = 0, 0.5, 1 on the three steps, so the
# learned-prior term's β factor is exercised.
OVERRIDES = {"train.beta_warmup_steps": 2}


def _port_cfg(cfg_j):
    return config_from_dict(json.loads(cfg_j.to_json()))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    b, (h, w, c) = cfg.train.batch_size, cfg.model.image_shape
    return [pack_bits((rng.random((b, h, w, c)) < 0.3).astype(np.uint8))
            for _ in range(n)]


def _jax_noise(cfg, rng_key, step, b):
    """The G phase's ε and the critic's z_p of step ``step`` (step.py:517-
    519, :390, :396)."""
    z = cfg.model.z_dim
    step_key = jax.random.fold_in(rng_key, step)
    _, k_g, *k_ds = jax.random.split(step_key, 2 + cfg.adversarial.n_critic)
    eps = jax.random.normal(k_g, (b, z), jnp.float32)
    z_p = [jax.random.normal(jax.random.split(k)[1], (b, z), jnp.float32)
           for k in k_ds]
    return {"eps": torch.from_numpy(np.array(eps)),
            "z_p": torch.from_numpy(np.array(jnp.stack(z_p)))}


@pytest.fixture(scope="module")
def runs():
    cfg_j = tiny_config("mnist_advprior", **OVERRIDES)
    m = cfg_j.model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "build_model", lambda mc: FlaxConvVAE(
            z_dim=m.z_dim, widths=tuple(m.widths), dense=m.dense,
            image_shape=tuple(m.image_shape), dtype=jnp.float32))
        fns = jstep.make_train_fns(cfg_j)
        state = fns.init_fn(jax.random.PRNGKey(0))
        step = jax.jit(fns.train_step)
        batches = _batches(cfg_j, N_STEPS)
        j_states, j_metrics = [state], []
        for t in range(N_STEPS):
            state, met = step(state, {"image_packed": batches[t]})
            j_states.append(state)
            j_metrics.append({k: float(v) for k, v in met.items()})

    cfg_t = _port_cfg(cfg_j)
    tfns = tstep.make_train_fns(cfg_t, device="cpu", dtype=torch.float32)
    ts = tfns.init_fn(cfg_t.train.seed)
    s0 = j_states[0]
    ts.model.load_state_dict(params_from_flax(_np_tree(s0.params)))
    ts.d.load_state_dict(d_params_from_flax(_np_tree(s0.d_params)))
    p0 = {k: v.clone() for k, v in ts.model.state_dict().items()}
    t_metrics, moments = [], None
    for t in range(N_STEPS):
        noise = _jax_noise(cfg_j, s0.rng, t, cfg_j.train.batch_size)
        ts, met = tfns.train_step(
            ts, {"image_packed": torch.from_numpy(batches[t])}, noise=noise)
        t_metrics.append({k: float(v) for k, v in met.items()})
        if t == 0:
            moments = ([m.clone() for m in ts.opt.mu],
                       [m.clone() for m in ts.d_opt.mu])
    return dict(cfg_j=cfg_j, j_states=j_states, j_metrics=j_metrics, ts=ts,
                t_metrics=t_metrics, moments=moments, p0=p0)


def _scale_rel(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(want, np.float32))
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("t", range(N_STEPS))
def test_step_metrics_match_jax(runs, t):
    got, want = runs["t_metrics"][t], runs["j_metrics"][t]
    assert set(got) == set(want) == {
        "loss", "recon", "kl", "elbo", "g_adv", "grad_norm", "d_loss",
        "d_acc", "beta"}
    b = runs["cfg_j"].train.batch_size
    for k in want:
        if k == "d_acc":
            # a fraction over 2·B logits: one logit on the other side of 0
            # would move it by 1/(2B)
            assert abs(got[k] - want[k]) <= 0.5 / b + 1e-7, (k, got, want)
        else:
            # f32 conv nets that agree to ~1e-5 relative, 784-pixel sums
            # (|recon| ~ 550 nats), batch means: 1e-4 rel / 1e-3 abs
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-3, err_msg=k)
    assert got["beta"] == [0.0, 0.5, 1.0][t]


def _named(module, tensors):
    return dict(zip([n for n, _ in module.named_parameters()], tensors))


def test_adam_first_moments_after_step0_match_optax(runs):
    """After one step m = (1 − b1)·clip(g): 0.1 × the clipped gradients for
    G and 0.5 × for D. Scale-relative per tensor ≤ 1e-3: the same f32
    gradients, summed over the batch in another order."""
    ts, s1 = runs["ts"], runs["j_states"][1]
    g_mu, d_mu = runs["moments"]
    want_g = params_from_flax(_np_tree(s1.opt_state[1][0].mu))
    want_d = d_params_from_flax(_np_tree(s1.d_opt_state[1][0].mu))
    for got, want in ((_named(ts.model, g_mu), want_g),
                      (_named(ts.d, d_mu), want_d)):
        assert set(got) == set(want)
        worst = max(_scale_rel(got[k], want[k].numpy()) for k in want)
        assert worst <= 1e-3, worst


def test_param_change_after_three_steps_matches_jax(runs):
    """Δθ after 3 steps, scale-relative per tensor ≤ 1e-2. Looser than the
    moments' bar because Adam divides by √v̂: an element whose gradient is
    tiny has an update of order lr whatever its size, so its few-ulp
    gradient differences are amplified; the first update has lr 0, so this
    covers the two steps with lr > 0 and β > 0."""
    ts, p0 = runs["ts"], runs["p0"]
    want = params_from_flax(_np_tree(runs["j_states"][-1].params))
    want0 = params_from_flax(_np_tree(runs["j_states"][0].params))
    got = ts.model.state_dict()
    worst = max(_scale_rel(got[k] - p0[k], (want[k] - want0[k]).numpy())
                for k in want)
    assert worst <= 1e-2, worst
    # D's parameters moved only by the D optimizer: the G phase left their
    # .grad untouched
    assert all(p.grad is None for p in ts.d.parameters())
    assert all(p.grad is None for p in ts.model.parameters())


def test_lr_is_zero_at_the_first_update():
    """optax's warmup starts at init_value 0, read at the count before its
    increment: the first G update leaves the params where they were."""
    cfg = _port_cfg(tiny_config("mnist_advprior"))
    p = torch.nn.Parameter(torch.ones(3))
    opt = tstep._make_optimizer(cfg, [p])
    opt.step([torch.full((3,), 2.0)])
    assert torch.equal(p.detach(), torch.ones(3))
    assert opt.lr(0) == 0.0 and opt.lr(1) > 0.0


@pytest.mark.parametrize("which", ["g", "d"])
def test_optimizers_match_optax(which):
    """The port's clipped Adam against the optax chain of ``_make_optimizer``
    (``_make_d_optimizer``) on random gradients whose global norm crosses
    the clip of 5 both ways, over steps that cross the warmup boundary
    (steps=8: warmup 4, cosine decay to step 8)."""
    cfg_j = tiny_config("mnist_advprior", **{"train.steps": 8})
    cfg_t = _port_cfg(cfg_j)
    rng = np.random.default_rng(7)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = (jstep._make_optimizer(cfg_j) if which == "g"
          else jstep._make_d_optimizer(cfg_j))
    state = tx.init(params)
    t_params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = (tstep._make_optimizer(cfg_t, t_params) if which == "g"
           else tstep._make_d_optimizer(cfg_t, t_params))
    j_params = params
    for t in range(8):
        scale = 3.0 if t % 2 else 0.1        # global norm ~13 or ~0.4
        grads = [(scale * rng.normal(size=s)).astype(np.float32)
                 for s in shapes]
        updates, state = tx.update(grads, state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        norm = opt.step([torch.from_numpy(g) for g in grads])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                                   rtol=1e-6)
        for got, want in zip(t_params, j_params):
            # f32 Adam arithmetic in another order: a few ulps of the
            # params (|θ| ~ 1) and of the updates (~lr)
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("variant", ["learned_prior", "aae"])
def test_adversarial_loss_terms_match_jax(variant):
    """generator_adv_term, discriminator_loss (with and without label
    smoothing) and d_loss_floor against the reference's."""
    rng = np.random.default_rng(3)
    q, p = (4.0 * rng.normal(size=(2, 64))).astype(np.float32)
    q[0], p[0] = 0.0, 0.0                  # the accuracy's boundary cases
    np.testing.assert_allclose(
        tlosses.generator_adv_term(torch.from_numpy(q), variant).numpy(),
        np.asarray(jlosses.generator_adv_term(q, variant)), rtol=1e-6,
        atol=1e-6)
    for s in (0.0, 0.1):
        got = tlosses.discriminator_loss(torch.from_numpy(q),
                                         torch.from_numpy(p), s)
        want = jlosses.discriminator_loss(q, p, s)
        for g, w in zip(got, want):
            # f32 softplus means over 64 logits
            np.testing.assert_allclose(float(g), float(w), rtol=1e-6,
                                       atol=1e-6)
        assert tlosses.d_loss_floor(s) == jlosses.d_loss_floor(s)


def test_step_noise_depends_only_on_seed_and_step():
    """Replaying a step from the same weights gives the same result, the
    next step draws other noise, and the global generator is untouched;
    eval_step is deterministic in (seed, batch) and reports the ELBO."""
    cfg = _port_cfg(tiny_config("mnist_advprior"))
    fns = tstep.make_train_fns(cfg, device="cpu", dtype=torch.float32)
    batch = {"image_packed": torch.from_numpy(_batches(cfg, 1)[0])}
    before = torch.random.get_rng_state()
    a, b = fns.init_fn(0), fns.init_fn(0)
    _, ma = fns.train_step(a, batch)
    _, mb = fns.train_step(b, batch)
    assert {k: float(v) for k, v in ma.items()} == \
        {k: float(v) for k, v in mb.items()}
    c = fns.init_fn(0)
    c.step = 1
    _, mc = fns.train_step(c, batch)
    assert float(mc["d_loss"]) != float(ma["d_loss"])
    ea, eb = fns.eval_step(a, batch), fns.eval_step(b, batch)
    assert {k: float(v) for k, v in ea.items()} == \
        {k: float(v) for k, v in eb.items()}
    np.testing.assert_allclose(float(ea["valid_elbo"]),
                               float(ea["valid_recon"] - ea["valid_kl"]),
                               rtol=1e-6)
    assert torch.equal(torch.random.get_rng_state(), before)


@pytest.mark.parametrize("knob", [
    "train.objective=iwae", "model.prior=gaussian",
    "adversarial.variant=biadversarial", "adversarial.r1_gamma=1.0",
    "adversarial.d_spectral_norm=true", "adversarial.d_lr_schedule=cosine",
    "train.free_bits=0.5", "train.ema_decay=0.99", "train.grad_accum=2"])
def test_knobs_outside_the_slice_raise(knob):
    """Knobs the port does not run raise NotImplementedError naming the
    knob. The trained priors, the IWAE objective and free bits are ported:
    they build, and raise only where the reference refuses them (a
    ValueError)."""
    from apv_tpu_torch.utils.config import apply_overrides
    cfg = apply_overrides(_port_cfg(tiny_config("mnist_advprior")), [knob])
    refused_with = {
        "train.objective=iwae": ("train.free_bits=0.5", "free_bits"),
        "model.prior=gaussian": ("train.flow_dispersion_penalty=1.0",
                                 "flow_dispersion_penalty"),
        "train.free_bits=0.5": ("train.objective=iwae", "free_bits")}
    if knob in refused_with:
        other, match = refused_with[knob]
        tstep.make_train_fns(cfg, device="cpu")
        with pytest.raises(ValueError, match=match):
            tstep.make_train_fns(apply_overrides(cfg, [other]), device="cpu")
        return
    with pytest.raises(NotImplementedError, match=knob.split("=")[0]):
        tstep.make_train_fns(cfg, device="cpu")


@pytest.mark.parametrize("resident,packed", [(True, True), (False, False)])
def test_train_loop_writes_metrics(tmp_path, resident, packed):
    """Two steps of the loop in calls of 2, with the preset's resident
    bit-packed data and with streamed float rows: config.json and one
    metrics.jsonl line per step, finite; a second run into the same
    results dir is refused unless overwrite or resume."""
    cfg = _port_cfg(tiny_config(
        "mnist_advprior", tmp_dir=str(tmp_path),
        **{"train.log_every": 1, "train.steps_per_call": 2,
           "train.steps": 2, "train.checkpoint_every": 2,
           "train.eval_every": 0, "data.device_resident": resident,
           "data.bit_pack": packed}))
    bits = (np.random.default_rng(1).random((64, 28, 28, 1)) < 0.3)
    arrays = ({"image_packed": pack_bits(bits.astype(np.uint8))} if packed
              else {"image": bits.astype(np.float32)})
    state = train_loop(cfg, arrays=arrays, device="cpu")
    assert state.step == 2
    out = tmp_path / cfg.name
    saved = json.loads((out / "config.json").read_text())
    assert saved == json.loads(json.dumps(dataclasses.asdict(cfg)))
    lines = [json.loads(s) for s in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1]
    for r in lines:
        assert {"loss", "recon", "kl", "elbo", "g_adv", "grad_norm",
                "d_loss", "d_acc", "beta"} <= set(r)
        assert all(np.isfinite(v) for v in r.values())
    assert "images_per_sec_per_chip" in lines[1]
    with pytest.raises(FileExistsError):
        train_loop(cfg, arrays=arrays, device="cpu")
    # resume restores the step-2 checkpoint; with no step left it returns
    # the restored state, equal to the run's
    resumed = train_loop(cfg, arrays=arrays, device="cpu", resume=True)
    assert resumed.step == 2
    for a, b in zip(resumed.model.state_dict().values(),
                    state.model.state_dict().values()):
        assert torch.equal(a, b)
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 2
    train_loop(cfg, arrays=arrays, device="cpu", overwrite=True)
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 2
