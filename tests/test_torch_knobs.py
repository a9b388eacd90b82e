"""The port's training knobs against ``apv_tpu``'s: the cosine and
floor-adaptive D learning rates, gradient accumulation and the EMA shadow.

Optimizer level: ``ClippedAdam`` with ``every_k`` against
``optax.MultiSteps`` of the reference's chains, and the cosine D schedule
against ``optax.cosine_decay_schedule``. Step level: tiny
``mnist_advprior`` steps through ``apv_tpu.training.step.make_train_fns``
(its nets built in float32 by patching ``build_model``) and through the
port's on the CPU, from the same converted weights and with JAX's noise
handed to the port, one knob at a time; the bars are the other step
tests': metrics element-wise, first moments ≤ 1e-3 and Δθ ≤ 1e-2 scale-
relative per tensor. Then the port alone, mirroring the reference's own
knob tests (``tests/test_train.py``): the throttle's factors, the EMA
recurrence and its checkpoints across configs, the buffering steps of an
accumulation and a resume inside one.
"""

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
from apv_tpu.models.discriminator import PixelDiscriminator as FlaxPixelD
from apv_tpu.training import step as jstep
from apv_tpu_torch.api import _p
from apv_tpu_torch.convert import d_params_from_flax, params_from_flax
from apv_tpu_torch.training import losses as tlosses
from apv_tpu_torch.training import step as tstep
from apv_tpu_torch.training.loop import train_loop
from apv_tpu_torch.utils import checkpoint as ckpt
from apv_tpu_torch.utils.config import apply_overrides, config_from_dict

torch.set_num_threads(1)

FLOOR = {"adversarial.d_lr_schedule": "floor_adaptive",
         "adversarial.label_smoothing": 0.1, "adversarial.d_lr": 1e-2}
BIADV = {"adversarial.variant": "biadversarial",
         "adversarial.pixel_d_widths": "[8,16]"}
# each knob alone, at tiny size, batch 8, β warmed over 2 steps
KNOBS = {
    "cosine": ({"adversarial.d_lr_schedule": "cosine",
                "adversarial.d_lr": 1e-2, "adversarial.d_lr_end": 1e-4,
                "train.steps": 4}, 3),
    "floor_adaptive": (FLOOR, 3),
    "floor_adaptive_biadv": ({**FLOOR, **BIADV}, 3),
    "ema": ({"train.ema_decay": 0.5}, 3),
    "grad_accum": ({"train.grad_accum": 2}, 4),
}


def _port_cfg(cfg_j):
    return config_from_dict(json.loads(cfg_j.to_json()))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _scale_rel(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.array(want, np.float32))
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _flax_vae(m):
    return FlaxConvVAE(z_dim=m.z_dim, widths=tuple(m.widths), dense=m.dense,
                       image_shape=tuple(m.image_shape), dtype=jnp.float32)


def _batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    b, (h, w, c) = cfg.train.batch_size, cfg.model.image_shape
    return [pack_bits((rng.random((b, h, w, c)) < 0.3).astype(np.uint8))
            for _ in range(n)]


def _jax_noise(cfg, rng_key, step, b):
    """Step ``step``'s G ε and critic z_p (apv_tpu/training/step.py's key
    splits)."""
    z = cfg.model.z_dim
    _, k_g, *k_ds = jax.random.split(jax.random.fold_in(rng_key, step),
                                     2 + cfg.adversarial.n_critic)
    return {"eps": _t(jax.random.normal(k_g, (b, z), jnp.float32)),
            "z_p": _t(jnp.stack([
                jax.random.normal(jax.random.split(k)[1], (b, z),
                                  jnp.float32) for k in k_ds]))}


def _inner(opt_state):
    """The clip+Adam chain's state, inside optax.MultiSteps or not."""
    return getattr(opt_state, "inner_opt_state", opt_state)


def _saturated_d(fns, step, state, cfg_j, batch, n=25):
    """D's parameters after ``n`` steps against a frozen G whose posterior
    mean is shifted by 2 (the reference's saturation set-up,
    tests/test_train.py:170): a D whose loss stands below chance, so the
    floor-adaptive factors are not all 1."""
    frozen = state.params
    for _ in range(n):
        state, _ = step(state, {"image_packed": batch})
        state = state.replace(params=frozen)
    return state.d_params


def _shift_posterior(params, z_dim):
    enc = dict(params["encoder"])
    head = dict(enc["gaussian_head"])
    head["bias"] = head["bias"].at[:z_dim].set(2.0)
    enc["gaussian_head"] = head
    return {**params, "encoder": enc}


@pytest.fixture(scope="module", params=sorted(KNOBS))
def pair(request):
    knob = request.param
    extra, n_steps = KNOBS[knob]
    cfg_j = tiny_config("mnist_advprior", **{
        "train.batch_size": 8, "train.beta_warmup_steps": 2, **extra})
    batches = _batches(cfg_j, n_steps)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "build_model", _flax_vae)
        mp.setattr(jstep, "PixelDiscriminator",
                   lambda widths: FlaxPixelD(widths, dtype=jnp.float32))
        fns = jstep.make_train_fns(cfg_j)
        state = fns.init_fn(jax.random.PRNGKey(0))
        step = jax.jit(fns.train_step)
        if knob.startswith("floor"):
            state = state.replace(params=_shift_posterior(
                state.params, cfg_j.model.z_dim))
            state = state.replace(d_params=_saturated_d(
                fns, step, state, cfg_j, batches[0]))
            if cfg_j.train.ema_decay > 0.0:
                state = state.replace(ema_params=state.params)
        j_states, j_metrics = [state], []
        for t in range(n_steps):
            state, met = step(state, {"image_packed": batches[t]})
            j_states.append(state)
            j_metrics.append({k: float(v) for k, v in met.items()})

    cfg_t = _port_cfg(cfg_j)
    tfns = tstep.make_train_fns(cfg_t, device="cpu", dtype=torch.float32)
    ts = tfns.init_fn(cfg_t.train.seed)
    s0 = j_states[0]
    ts.model.load_state_dict(params_from_flax(_np_tree(s0.params)))
    ts.d.load_state_dict(d_params_from_flax(_np_tree(s0.d_params)))
    if ts.ema_model is not None:
        ts.ema_model.load_state_dict(ts.model.state_dict())
    p0 = {k: v.clone() for k, v in ts.model.state_dict().items()}
    d0 = {k: v.clone() for k, v in ts.d.state_dict().items()}
    t_metrics, moments, accs = [], [], []
    for t in range(n_steps):
        ts, met = tfns.train_step(
            ts, {"image_packed": torch.from_numpy(batches[t])},
            noise=_jax_noise(cfg_j, s0.rng, t, cfg_j.train.batch_size))
        t_metrics.append({k: float(v) for k, v in met.items()})
        moments.append(([m.clone() for m in ts.opt.mu],
                        [m.clone() for m in ts.d_opt.mu]))
        accs.append(None if ts.opt.acc is None
                    else [a.clone() for a in ts.opt.acc])
    return dict(knob=knob, cfg_j=cfg_j, j_states=j_states,
                j_metrics=j_metrics, ts=ts, t_metrics=t_metrics,
                moments=moments, accs=accs, p0=p0, d0=d0)


def _named(module, tensors):
    return dict(zip([n for n, _ in module.named_parameters()], tensors))


def test_knob_step_metrics_match_jax(pair):
    """Every metric of every step, the floor-adaptive factors at 1e-5
    absolute. On the saturated set-up the throttle engages (a factor
    below 1 in both packages), and under the biadversarial D the two
    factors differ: each D is throttled by its own loss."""
    b = pair["cfg_j"].train.batch_size
    if pair["knob"].startswith("floor"):
        for met in (pair["t_metrics"], pair["j_metrics"]):
            assert min(m["d_lr_factor"] for m in met) < 0.9, met
            if "px_d_lr_factor" in met[0]:
                assert all(abs(m["d_lr_factor"] - m["px_d_lr_factor"])
                           > 0.05 for m in met), met
    for got, want in zip(pair["t_metrics"], pair["j_metrics"]):
        assert set(got) == set(want)
        for k in want:
            if k.endswith("d_acc"):
                # a fraction over 2·B logits: one logit across 0 moves it
                assert abs(got[k] - want[k]) <= 0.5 / b + 1e-7, k
            elif k.endswith("lr_factor"):
                assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
            else:
                # f32 conv nets that agree to ~1e-5 relative, 784-pixel
                # sums, batch means
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           atol=1e-3, err_msg=k)


def test_knob_first_moments_match_optax(pair):
    """Adam's first moments after the first applied update (micro-step k
    under grad_accum k) for G and D, and under grad_accum the running mean
    of the buffering micro-step: scale-relative per tensor ≤ 1e-3."""
    ts, k = pair["ts"], pair["cfg_j"].train.grad_accum
    j_after = pair["j_states"][k]
    g_mu, d_mu = pair["moments"][k - 1]
    want_g = params_from_flax(_np_tree(_inner(j_after.opt_state)[1][0].mu))
    want_d = d_params_from_flax(_np_tree(
        _inner(j_after.d_opt_state)[1][0].mu))
    for got, want in ((_named(ts.model, g_mu), want_g),
                      (_named(ts.d, d_mu), want_d)):
        assert set(got) == set(want)
        worst = max(_scale_rel(got[n], want[n].numpy()) for n in want)
        assert worst <= 1e-3, worst
    if k > 1:
        acc = _named(ts.model, pair["accs"][0])
        want = params_from_flax(_np_tree(
            pair["j_states"][1].opt_state.acc_grads))
        assert int(pair["j_states"][1].opt_state.mini_step) == 1
        worst = max(_scale_rel(acc[n], want[n].numpy()) for n in want)
        assert worst <= 1e-3, worst


def test_knob_param_change_matches_jax(pair):
    """Δθ of the VAE and of D after the run's 3-4 (micro-)steps,
    scale-relative per tensor ≤ 1e-2; the optimizers' counts tick once per
    applied update."""
    ts, s_last = pair["ts"], pair["j_states"][-1]
    for module, start, conv, now, then in (
            (ts.model, pair["p0"], params_from_flax, s_last.params,
             pair["j_states"][0].params),
            (ts.d, pair["d0"], d_params_from_flax, s_last.d_params,
             pair["j_states"][0].d_params)):
        want, want0 = conv(_np_tree(now)), conv(_np_tree(then))
        got = module.state_dict()
        worst = max(_scale_rel(got[n] - start[n], (want[n] - want0[n]).numpy())
                    for n in want)
        assert worst <= 1e-2, worst
    n_steps, k = len(pair["t_metrics"]), pair["cfg_j"].train.grad_accum
    assert ts.opt.count == ts.d_opt.count == n_steps // k
    assert int(_inner(s_last.opt_state)[1][0].count) == n_steps // k


def test_knob_ema_shadow_matches_jax(pair):
    """The shadow after 3 steps: its change from θ0 within 1e-2 of that
    change, scale-relative per tensor; no shadow without the knob."""
    ts = pair["ts"]
    if pair["cfg_j"].train.ema_decay == 0.0:
        assert ts.ema_model is None and pair["j_states"][-1].ema_params == {}
        return
    want = params_from_flax(_np_tree(pair["j_states"][-1].ema_params))
    want0 = params_from_flax(_np_tree(pair["j_states"][0].params))
    got, p0 = ts.ema_model.state_dict(), pair["p0"]
    worst = max(_scale_rel(got[n] - p0[n], (want[n] - want0[n]).numpy())
                for n in want)
    assert worst <= 1e-2, worst


# -- the optimizers -----------------------------------------------------------

@pytest.mark.parametrize("which", ["g", "d", "d_cosine"])
@pytest.mark.parametrize("k", [2, 3])
def test_optimizers_match_optax_multisteps(which, k):
    """``ClippedAdam(every_k=k)`` against ``optax.MultiSteps(chain(clip,
    adam), k)`` as ``_make_optimizer``/``_make_d_optimizer`` build them
    (the D's also with the cosine schedule), over 8 micro-steps whose
    global norms cross the clip of 5 both ways: parameters bit-identical
    on buffering micro-steps, agreeing at rtol 1e-6/atol 1e-7 always."""
    over = {"train.steps": 8, "train.grad_accum": k}
    if which == "d_cosine":
        over.update({"adversarial.d_lr_schedule": "cosine",
                     "adversarial.d_lr_end": 1e-6})
    cfg_j = tiny_config("mnist_advprior", **over)
    cfg_t = _port_cfg(cfg_j)
    rng = np.random.default_rng(7)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    make_j = jstep._make_optimizer if which == "g" else jstep._make_d_optimizer
    make_t = tstep._make_optimizer if which == "g" else tstep._make_d_optimizer
    tx = make_j(cfg_j)
    state = tx.init(params)
    t_params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_t(cfg_t, t_params)
    j_params = params
    for t in range(8):
        scale = 3.0 if t % 2 else 0.1        # global norm ~13 or ~0.4
        grads = [(scale * rng.normal(size=s)).astype(np.float32)
                 for s in shapes]
        before = [p.detach().clone() for p in t_params]
        updates, state = tx.update(grads, state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        norm = opt.step([torch.from_numpy(g) for g in grads])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                                   rtol=1e-6)
        applied = (t + 1) % k == 0
        assert opt.mini_step == int(state.mini_step) == (t + 1) % k
        assert opt.count == int(state.inner_opt_state[1][0].count)
        for got, want, was in zip(t_params, j_params, before):
            if not applied:
                assert torch.equal(got.detach(), was)
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=1e-6, atol=1e-7)
        for got, want in zip(opt.acc, state.acc_grads):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_critic,accum", [(1, 1), (3, 2)])
def test_d_cosine_schedule_matches_optax(n_critic, accum):
    """The cosine D schedule against ``optax.cosine_decay_schedule`` over
    its horizon of D updates, max(1, steps // grad_accum) ×
    max(1, n_critic), and past it, at rtol 1e-6."""
    cfg = _port_cfg(tiny_config("mnist_advprior", **{
        "train.steps": 10, "train.grad_accum": accum,
        "adversarial.n_critic": n_critic, "adversarial.d_lr": 2e-4,
        "adversarial.d_lr_end": 2e-6,
        "adversarial.d_lr_schedule": "cosine"}))
    horizon = max(1, 10 // accum) * n_critic
    opt = tstep._make_d_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))])
    want = optax.cosine_decay_schedule(2e-4, horizon, alpha=2e-6 / 2e-4)
    for count in range(horizon + 3):
        np.testing.assert_allclose(opt.lr(count), float(want(count)),
                                   rtol=1e-6)
    assert opt.lr(horizon + 2) == pytest.approx(2e-6, rel=1e-6)
    assert opt.every_k == accum


# -- the port alone: the reference's knob tests -------------------------------

def _cfg(preset="mnist_advprior", **extra):
    return _port_cfg(tiny_config(preset, **extra))


def _image_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    h, w, c = cfg.model.image_shape
    return {"image": torch.from_numpy(
        (rng.random((cfg.train.batch_size, h, w, c)) < 0.3)
        .astype(np.float32))}


def _steps(cfg, n, batch=None, state=None, fns=None):
    fns = fns or tstep.make_train_fns(cfg, device="cpu", dtype=torch.float32)
    state = state or fns.init_fn(0)
    batch = batch or _image_batch(cfg)
    hist = []
    for _ in range(n):
        state, m = fns.train_step(state, batch)
        hist.append({k: float(v) for k, v in m.items()})
    return state, hist


def _params(module):
    return [p.detach().clone() for p in module.parameters()]


def test_d_lr_cosine_schedule_decays_updates():
    """The cosine D schedule's updates shrink to a small fraction of the
    first by the end of the run, where the constant schedule's stay the
    same order; an unknown schedule is refused (tests/test_train.py:132)."""
    def d_deltas(schedule, n=8):
        cfg = _cfg(**{"adversarial.d_lr_schedule": schedule,
                      "adversarial.d_lr_end": "1e-8", "train.steps": str(n)})
        fns = tstep.make_train_fns(cfg, device="cpu", dtype=torch.float32)
        state, batch, deltas = fns.init_fn(0), _image_batch(cfg), []
        for _ in range(n):
            before = _params(state.d)
            state, _ = fns.train_step(state, batch)
            deltas.append(float(sum(((a - b) ** 2).sum() for a, b in
                                    zip(_params(state.d), before))) ** 0.5)
        return deltas

    const, cos = d_deltas("constant"), d_deltas("cosine")
    assert const[-1] > 0.3 * const[0], const
    assert cos[-1] < 0.05 * cos[0], cos
    assert cos[-1] < 0.05 * const[-1], (cos[-1], const[-1])
    with pytest.raises(ValueError, match="d_lr_schedule"):
        tstep.make_train_fns(apply_overrides(
            _cfg(), ["adversarial.d_lr_schedule=nope"]), device="cpu")


def _frozen_g_factors(cfg, n):
    """``n`` steps with G frozen at a posterior mean shifted by 2: the
    reported losses and factors of each step."""
    fns = tstep.make_train_fns(cfg, device="cpu", dtype=torch.float32)
    state = fns.init_fn(0)
    with torch.no_grad():
        head = state.model.encoder.head
        head.bias[:cfg.model.z_dim] = 2.0
    frozen = {k: v.clone() for k, v in state.model.state_dict().items()}
    batch, hist = _image_batch(cfg), []
    for _ in range(n):
        state, m = fns.train_step(state, batch)
        state.model.load_state_dict(frozen)
        hist.append({k: float(v) for k, v in m.items()})
    return hist


def _want_factor(loss):
    floor, chance = tlosses.d_loss_floor(0.1), 2 * np.log(2.0)
    return np.clip((np.asarray(loss) - floor) / (chance - floor), 0, 1)


def test_d_lr_floor_adaptive_throttles_at_saturation():
    """Against a frozen G whose posterior D can separate, the reported
    factor is the clipped floor distance of the reported loss, starts near
    1 and falls as D saturates (tests/test_train.py:170)."""
    hist = _frozen_g_factors(_cfg(**FLOOR), 60)
    factors = [h["d_lr_factor"] for h in hist]
    np.testing.assert_allclose(factors, _want_factor(
        [h["d_loss"] for h in hist]), atol=1e-6)
    assert factors[0] > 0.9, factors[0]
    assert min(factors) < 0.6, min(factors)


def test_floor_adaptive_biadversarial_per_d_factors():
    """Under the biadversarial D each factor is its own loss's clipped
    floor distance, and the two differ (tests/test_train.py:212, which
    asserts nothing of the difference)."""
    hist = _frozen_g_factors(_cfg(**FLOOR, **BIADV), 25)
    for lk, fk in (("d_loss", "d_lr_factor"),
                   ("px_d_loss", "px_d_lr_factor")):
        np.testing.assert_allclose([h[fk] for h in hist], _want_factor(
            [h[lk] for h in hist]), atol=1e-6)
    assert max(abs(h["d_lr_factor"] - h["px_d_lr_factor"])
               for h in hist) > 0.1


def test_update_scales_leave_the_moments():
    """``ClippedAdam.step(grads, scales)`` scales each applied update by
    its factor and nothing else: the moments and count equal an unscaled
    optimizer's on the same gradients, a factor of 0.5 halves the update
    and a factor of 0 freezes its parameters."""
    rng = np.random.default_rng(3)
    shapes = [(3, 4), (5,)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    plain = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    scaled = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt_p = tstep.ClippedAdam(plain, lambda c: 1e-2, clip_norm=5.0, b1=0.5)
    opt_s = tstep.ClippedAdam(scaled, lambda c: 1e-2, clip_norm=5.0, b1=0.5)
    for _ in range(3):
        grads = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 for s in shapes]
        b_p = [p.detach().clone() for p in plain]
        b_s = [p.detach().clone() for p in scaled]
        opt_p.step(grads)
        opt_s.step(grads, [torch.tensor(0.5), torch.tensor(0.0)])
        # the update is ~1e-2 on parameters ~1: a few ulps of them
        np.testing.assert_allclose((scaled[0].detach() - b_s[0]).numpy(),
                                   0.5 * (plain[0].detach() - b_p[0]).numpy(),
                                   rtol=0, atol=1e-6)
        assert torch.equal(scaled[1].detach(), b_s[1])
    for a, b in zip(opt_p.mu + opt_p.nu, opt_s.mu + opt_s.nu):
        assert torch.equal(a, b)
    assert opt_p.count == opt_s.count == 3


def test_ema_params_recurrence_and_eval_selection():
    """The shadow starts at the parameters and follows e' = d·e + (1 − d)·θ
    each step; ``api._p`` reads it when the knob is on and the raw
    parameters when off (tests/test_train.py:354)."""
    cfg = _cfg("mnist_vae", **{"train.ema_decay": 0.9})
    fns = tstep.make_train_fns(cfg, device="cpu", dtype=torch.float32)
    state = fns.init_fn(0)
    for e, p in zip(state.ema_model.parameters(), state.model.parameters()):
        assert torch.equal(e, p) and not e.requires_grad
    prev = _params(state.ema_model)
    state, _ = fns.train_step(state, _image_batch(cfg))
    for e, was, p in zip(state.ema_model.parameters(), prev,
                         state.model.parameters()):
        np.testing.assert_allclose(e.numpy(), (0.9 * was + 0.1 * p.detach())
                                   .numpy(), rtol=1e-6, atol=1e-7)
    assert _p(state, cfg) is state.ema_model
    cfg_off = _cfg("mnist_vae")
    state_off = tstep.make_train_fns(cfg_off, device="cpu").init_fn(0)
    assert state_off.ema_model is None
    assert _p(state_off, cfg_off) is state_off.model
    assert "ema_model" not in state_off.state_dict()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_clipped_adam_ema_is_the_two_foreach_calls(dtype):
    """``ClippedAdam.ema_`` is e ← d·e, then e ← e + (1 − d)·θ: the two
    foreach calls in that order, bit for bit."""
    g = torch.Generator().manual_seed(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [torch.randn(s, generator=g).to(dtype) for s in shapes]
    ema = [torch.randn(s, generator=g).to(dtype) for s in shapes]
    want = [e.clone() for e in ema]
    torch._foreach_mul_(want, 0.999)
    torch._foreach_add_(want, params, alpha=1.0 - 0.999)
    opt = tstep.ClippedAdam(params, lambda c: 1e-3, clip_norm=1.0)
    before = [e.clone() for e in ema]
    opt.ema_(iter(ema), 0.999)
    for e, w, b in zip(ema, want, before):
        assert e.dtype == dtype and not torch.equal(e, b)
        assert torch.equal(e.view(torch.uint8), w.view(torch.uint8))


def _restore(cfg, path):
    fresh = tstep.make_train_fns(cfg, device="cpu",
                                 dtype=torch.float32).init_fn(0)
    return ckpt.restore_checkpoint(path, fresh)


def _assert_modules_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_ema_checkpoint_roundtrip(tmp_path):
    """The shadow is saved and restored bit for bit
    (tests/test_train.py:383)."""
    cfg = _cfg("mnist_vae", **{"train.ema_decay": 0.5})
    state, _ = _steps(cfg, 3)
    ckpt.save_checkpoint(tmp_path / "ck", state, 3)
    got = _restore(cfg, tmp_path / "ck")
    _assert_modules_equal(got.ema_model, state.ema_model)
    _assert_modules_equal(got.model, state.model)


def test_ema_checkpoint_cross_config_restore(tmp_path):
    """An EMA checkpoint restores under ema_decay=0 (its raw parameters,
    the shadow dropped) and a bare one under an EMA config (the shadow
    seeded from the restored parameters) (tests/test_train.py:397)."""
    cfg_on = _cfg("mnist_vae", **{"train.ema_decay": 0.5})
    cfg_off = _cfg("mnist_vae")
    state_on, _ = _steps(cfg_on, 2)
    ckpt.save_checkpoint(tmp_path / "on", state_on, 2)
    got = _restore(cfg_off, tmp_path / "on")
    assert got.ema_model is None
    _assert_modules_equal(got.model, state_on.model)
    assert _p(got, cfg_off) is got.model

    state_off, _ = _steps(cfg_off, 2)
    ckpt.save_checkpoint(tmp_path / "off", state_off, 2)
    got = _restore(cfg_on, tmp_path / "off")
    _assert_modules_equal(got.ema_model, state_off.model)
    _assert_modules_equal(got.model, state_off.model)
    assert got.ema_model.state_dict()["decoder.head.weight"].data_ptr() \
        != got.model.state_dict()["decoder.head.weight"].data_ptr()


def test_pre_ema_checkpoint_restores(tmp_path):
    """A checkpoint written before the shadow and the accumulators existed
    (no ``ema_model``, no ``acc``/``mini_step``) restores under an EMA
    config, a grad_accum config and a plain one (tests/test_train.py:484)."""
    cfg = _cfg("mnist_advprior")
    state, _ = _steps(cfg, 2)
    old = state.state_dict()
    assert "ema_model" not in old and "acc" not in old["opt"]
    (tmp_path / "old").mkdir()
    torch.save(old, tmp_path / "old" / "step_000000002.pt")
    for extra in ({}, {"train.ema_decay": 0.5}, {"train.grad_accum": 2}):
        got = _restore(_cfg("mnist_advprior", **extra), tmp_path / "old")
        _assert_modules_equal(got.model, state.model)
        _assert_modules_equal(got.d, state.d)
        assert got.step == 2 and got.opt.count == state.opt.count
        if got.ema_model is not None:
            _assert_modules_equal(got.ema_model, state.model)
        if got.opt.acc is not None:
            assert got.opt.mini_step == got.d_opt.mini_step == 0
            assert all(not a.any() for a in got.opt.acc + got.d_opt.acc)


def test_grad_accum_applies_every_k_steps():
    """With grad_accum=2 the parameters stay bit-identical on the
    buffering micro-step and move on the k-th (watched on the second
    window: the first update has lr 0); the ELBO still improves over 50
    micro-steps (tests/test_train.py:425)."""
    cfg = _cfg("mnist_vae", **{"train.grad_accum": 2})
    fns = tstep.make_train_fns(cfg, device="cpu", dtype=torch.float32)
    state, batch, snaps = fns.init_fn(0), _image_batch(cfg), []
    for _ in range(4):
        snaps.append(_params(state.model))
        state, _ = fns.train_step(state, batch)
    snaps.append(_params(state.model))
    assert all(torch.equal(a, b) for a, b in zip(snaps[3], snaps[2]))
    assert any(not torch.equal(a, b) for a, b in zip(snaps[4], snaps[3]))
    assert state.opt.count == 2 and state.opt.mini_step == 0
    _, hist = _steps(cfg, 50, batch)
    assert hist[-1]["elbo"] > hist[0]["elbo"] + 10


@pytest.mark.parametrize("variant", ["learned_prior", "biadversarial"])
def test_all_knobs_together_train(variant):
    """Cosine or floor-adaptive D, grad_accum 2 and the EMA together, with
    the latent D and under the biadversarial pair: finite metrics, both
    optimizers ticking once per window of 2 micro-steps, the shadow
    behind the parameters (tests/test_train.py:454)."""
    for schedule in ("cosine", "floor_adaptive"):
        extra = {"train.grad_accum": 2, "train.ema_decay": 0.9,
                 "adversarial.d_lr_schedule": schedule,
                 "adversarial.label_smoothing": 0.1,
                 "adversarial.variant": variant,
                 "adversarial.pixel_d_widths": "[8,16]"}
        state, hist = _steps(_cfg(**extra), 6)
        assert all(np.isfinite(v) for h in hist for v in h.values())
        assert state.opt.count == state.d_opt.count == 3
        assert any(not torch.equal(e, p) for e, p in zip(
            state.ema_model.parameters(), state.model.parameters()))


def _flat(state):
    sd = state.state_dict()
    head = [sd["step"], sd["seed"]]
    tensors = list(sd["model"].values()) + list(sd["ema_model"].values())
    for name in ("opt", "d_opt"):
        o = sd[name]
        head += [o["count"], o["mini_step"]]
        tensors += o["mu"] + o["nu"] + o["acc"]
    return head, tensors + list(sd["d"].values())


def test_resume_inside_an_accumulation_equals_straight_run(tmp_path):
    """grad_accum=2 with the EMA and the floor-adaptive D: 3 micro-steps
    (a checkpoint with a half-full window), a resume and 1 more equal 4
    straight micro-steps exactly: parameters, shadow, moments, counts,
    running means and micro-steps."""
    over = {"train.grad_accum": 2, "train.ema_decay": 0.9, **FLOOR,
            "train.steps": 4, "train.batch_size": 8,
            "train.eval_every": 0, "train.checkpoint_every": 100,
            "data.synthetic_size": 64}
    straight = apply_overrides(_cfg(tmp_dir=str(tmp_path), **over),
                               ["name=straight"])
    s_state = train_loop(straight, device="cpu")
    split = apply_overrides(straight, ["name=split"])
    first = train_loop(split, max_steps=3, device="cpu")
    assert first.opt.mini_step == first.d_opt.mini_step == 1
    assert any(a.any() for a in first.opt.acc)
    resumed = train_loop(split, resume=True, device="cpu")
    (ha, ta), (hb, tb) = _flat(resumed), _flat(s_state)
    assert ha == hb == [4, s_state.seed, 2, 0, 2, 0]
    assert len(ta) == len(tb) and all(torch.equal(a, b)
                                      for a, b in zip(ta, tb))


def test_grad_accum_checkpoint_restores_under_a_plain_config(tmp_path):
    """The eval-side entry points adopt a checkpoint's ema_decay but not
    its grad_accum, so a checkpoint saved mid-window restores under a
    config that does not accumulate: the parameters bit for bit, the
    running means left behind (the reference's orbax restore refuses this
    tree; ROADMAP queue C)."""
    cfg = _cfg("mnist_vae", **{"train.grad_accum": 2})
    state, _ = _steps(cfg, 3)
    assert state.opt.mini_step == 1
    ckpt.save_checkpoint(tmp_path / "ck", state, 3)
    got = _restore(_cfg("mnist_vae"), tmp_path / "ck")
    assert got.opt.acc is None and got.opt.count == state.opt.count
    _assert_modules_equal(got.model, state.model)
