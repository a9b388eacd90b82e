"""The port's CIFAR training (``cifar_advprior_resnet``) against ``apv_tpu``'s,
and the loop's validation, checkpoints and resume.

Three steps at ``tiny_config`` size run through
``apv_tpu.training.step.make_train_fns`` (jitted once for the module, its
model built in float32 by patching ``step.build_model``) and through the
port's ``make_train_fns`` on the CPU, from the same converted weights and
the same noise: the port is handed the dequantization u, the ε and the z_p
that JAX draws, re-derived with JAX's own key splits. The loop tests run
the port alone: 2 steps, a resume and 2 more must equal 4 straight steps
bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from apv_tpu.models.resnet_vae import ResNetVAE as FlaxResNetVAE
from apv_tpu.training import step as jstep
from apv_tpu_torch.convert import d_params_from_flax, params_from_flax
from apv_tpu_torch.training import step as tstep
from apv_tpu_torch.training.loop import load_train_arrays, train_loop
from apv_tpu_torch.utils import checkpoint as ckpt
from apv_tpu_torch.utils.config import apply_overrides, config_from_dict

torch.set_num_threads(1)

N_STEPS = 3
# batch 8; β warm-up over 2 steps: β = 0, 0.5, 1 on the three steps
OVERRIDES = {"train.batch_size": 8, "train.beta_warmup_steps": 2}


def _port_cfg(cfg_j):
    return config_from_dict(json.loads(cfg_j.to_json()))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _images(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (cfg.train.batch_size,
                                  *cfg.model.image_shape), dtype=np.uint8)
            for _ in range(n)]


def _jax_noise(cfg, rng_key, step, shape):
    """Step ``step``'s dequantization u, the G phase's ε and the critic's
    z_p (apv_tpu/training/step.py:517-520, data/preprocess.py:96, :390,
    :396)."""
    b, z = shape[0], cfg.model.z_dim
    step_key = jax.random.fold_in(rng_key, step)
    k_deq, k_g, *k_ds = jax.random.split(step_key,
                                         2 + cfg.adversarial.n_critic)
    u = jax.random.uniform(k_deq, shape, dtype=jnp.float32)
    eps = jax.random.normal(k_g, (b, z), jnp.float32)
    z_p = [jax.random.normal(jax.random.split(k)[1], (b, z), jnp.float32)
           for k in k_ds]
    return {"u": torch.from_numpy(np.array(u)),
            "eps": torch.from_numpy(np.array(eps)),
            "z_p": torch.from_numpy(np.array(jnp.stack(z_p)))}


@pytest.fixture(scope="module")
def runs():
    cfg_j = tiny_config("cifar_advprior_resnet", **OVERRIDES)
    m = cfg_j.model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "build_model", lambda mc: FlaxResNetVAE(
            z_dim=m.z_dim, widths=tuple(m.widths),
            blocks_per_stage=m.blocks_per_stage,
            image_shape=tuple(m.image_shape), upsample=m.upsample,
            activation=m.activation, norm=m.norm, dtype=jnp.float32))
        fns = jstep.make_train_fns(cfg_j)
        state = fns.init_fn(jax.random.PRNGKey(0))
        step = jax.jit(fns.train_step)
        images = _images(cfg_j, N_STEPS)
        j_states, j_metrics = [state], []
        for t in range(N_STEPS):
            state, met = step(state, {"image": images[t]})
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
        noise = _jax_noise(cfg_j, s0.rng, t, images[t].shape)
        ts, met = tfns.train_step(
            ts, {"image": torch.from_numpy(images[t])}, noise=noise)
        t_metrics.append({k: float(v) for k, v in met.items()})
        if t == 0:
            moments = ([m_.clone() for m_ in ts.opt.mu],
                       [m_.clone() for m_ in ts.d_opt.mu])
    return dict(cfg_j=cfg_j, j_states=j_states, j_metrics=j_metrics, ts=ts,
                t_metrics=t_metrics, moments=moments, p0=p0)


def _scale_rel(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(want, np.float32))
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("t", range(N_STEPS))
def test_cifar_step_metrics_match_jax(runs, t):
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
            # f32 ResNets that agree to ~1e-5 relative, 3072-pixel sums
            # (|recon| ~ 2e4 nats), batch means: 1e-4 rel / 1e-3 abs
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-3, err_msg=k)
    assert got["beta"] == [0.0, 0.5, 1.0][t]


def _named(module, tensors):
    return dict(zip([n for n, _ in module.named_parameters()], tensors))


def test_cifar_adam_first_moments_after_step0_match_optax(runs):
    """After one step m = (1 − b1)·clip(g) for G and D. Scale-relative per
    tensor ≤ 1e-3: the same f32 gradients, summed in another order, the
    recon term's through JAX's rule on one side and torch's autograd of
    the plain log-pmf on the other."""
    ts, s1 = runs["ts"], runs["j_states"][1]
    g_mu, d_mu = runs["moments"]
    want_g = params_from_flax(_np_tree(s1.opt_state[1][0].mu))
    want_d = d_params_from_flax(_np_tree(s1.d_opt_state[1][0].mu))
    for got, want in ((_named(ts.model, g_mu), want_g),
                      (_named(ts.d, d_mu), want_d)):
        assert set(got) == set(want)
        worst = max(_scale_rel(got[k], want[k].numpy()) for k in want)
        assert worst <= 1e-3, worst


def test_cifar_param_change_after_three_steps_matches_jax(runs):
    """Δθ after 3 steps, scale-relative per tensor ≤ 1e-2 (Adam's 1/√v̂
    amplifies the few-ulp gradient differences of tiny gradients; the
    first update has lr 0)."""
    ts, p0 = runs["ts"], runs["p0"]
    want = params_from_flax(_np_tree(runs["j_states"][-1].params))
    want0 = params_from_flax(_np_tree(runs["j_states"][0].params))
    got = ts.model.state_dict()
    worst = max(_scale_rel(got[k] - p0[k], (want[k] - want0[k]).numpy())
                for k in want)
    assert worst <= 1e-2, worst


def test_dequantized_eval_step_is_deterministic():
    """eval_step draws its u and ε from (seed, 0x7FFFFFFF) alone: the same
    batch scores the same twice, and a train step leaves it unchanged."""
    cfg = _port_cfg(tiny_config("cifar_advprior_resnet", **OVERRIDES))
    fns = tstep.make_train_fns(cfg, device="cpu", dtype=torch.float32)
    state = fns.init_fn(0)
    batch = {"image": torch.from_numpy(_images(cfg, 1)[0])}
    a, b = fns.eval_step(state, batch), fns.eval_step(state, batch)
    assert {k: float(v) for k, v in a.items()} == \
        {k: float(v) for k, v in b.items()}
    np.testing.assert_allclose(float(a["valid_elbo"]),
                               float(a["valid_recon"] - a["valid_kl"]),
                               rtol=1e-6)
    x_in, x_t = tstep.prepare_batch(cfg, batch, None,
                                    torch.full((8, 32, 32, 3), 0.5))
    np.testing.assert_array_equal(
        x_t.numpy(), batch["image"].numpy().astype(np.float32) / 255.0)
    np.testing.assert_array_equal(
        x_in.numpy(), (batch["image"].numpy() + np.float32(0.5))
        / np.float32(256.0) * 2 - 1)


# -- the loop: validation, checkpoints, resume --------------------------------

def _loop_cfg(tmp_path, name, **extra):
    over = {"train.batch_size": 8, "train.steps": 4, "train.steps_per_call": 2,
            "train.eval_every": 2, "train.checkpoint_every": 2,
            "train.log_every": 1, "data.synthetic_size": 64,
            "train.valid_fraction": 0.25, "train.beta_warmup_steps": 2}
    over.update(extra)
    return apply_overrides(
        _port_cfg(tiny_config("cifar_advprior_resnet", tmp_dir=str(tmp_path),
                              **over)), [f"name={name}"])


def _lines(cfg):
    path = cfg.results_dir + f"/{cfg.name}/metrics.jsonl"
    with open(path) as f:
        recs = [json.loads(s) for s in f.read().splitlines()]
    # the host clock's fields differ between runs
    return [{k: v for k, v in r.items()
             if k not in ("step_time_s", "images_per_sec_per_chip",
                          "host_step_ms", "sync_wait_ms", "host_lead_ms",
                          "g_phase_self_ms", "d_phase_self_ms",
                          "g_opt_self_ms", "d_opt_self_ms")}
            for r in recs]


def _flat_state(state):
    sd = state.state_dict()
    tensors = [*sd["model"].values(), *sd["d"].values(), *sd["opt"]["mu"],
               *sd["opt"]["nu"], *sd["d_opt"]["mu"], *sd["d_opt"]["nu"]]
    return (sd["step"], sd["seed"], sd["opt"]["count"],
            sd["d_opt"]["count"]), tensors


def _assert_states_equal(a, b):
    ha, ta = _flat_state(a)
    hb, tb = _flat_state(b)
    assert ha == hb and len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop")
    straight = _loop_cfg(tmp, "straight")
    s_state = train_loop(straight, device="cpu")
    split = _loop_cfg(tmp, "split")
    first = train_loop(split, max_steps=2, device="cpu")
    first_sd = _flat_state(first)
    resumed = train_loop(split, resume=True, device="cpu")
    return dict(tmp=tmp, straight=straight, s_state=s_state, split=split,
                first_sd=first_sd, resumed=resumed)


def test_resume_equals_straight_run_bit_for_bit(loop_runs):
    """4 steps straight vs 2, a resume and 2 more: the same parameters,
    optimizer moments and counts, and metrics lines."""
    r = loop_runs
    assert r["resumed"].step == r["s_state"].step == 4
    _assert_states_equal(r["resumed"], r["s_state"])
    assert _lines(r["split"]) == _lines(r["straight"])


def test_validation_and_best_checkpoint_records(loop_runs):
    """Validation at steps 2 and 4 over the unshuffled valid batches, the
    best valid ELBO in best.json and under best/, checkpoints at 2 and 4."""
    cfg = loop_runs["straight"]
    out = loop_runs["tmp"] / cfg.name
    lines = _lines(cfg)
    valid = [r for r in lines if "valid_elbo" in r]
    assert [r["step"] for r in valid] == [2, 4]
    assert set(valid[0]) == {"step", "valid_elbo", "valid_recon", "valid_kl"}
    assert all(np.isfinite(v) for r in lines for v in r.values())
    assert [r["step"] for r in lines if "loss" in r] == [0, 1, 2, 3]
    best = json.loads((out / "best.json").read_text())
    top = max(valid, key=lambda r: r["valid_elbo"])
    assert best == top
    assert ckpt.latest_step(out / "best") == top["step"]
    assert ckpt.latest_step(out / "checkpoints") == 4
    _, valid_arrays = load_train_arrays(cfg)
    assert len(valid_arrays["image"]) == 16          # 64 x 0.25, the tail


def test_checkpoint_restores_bit_for_bit_and_keeps_three(loop_runs, tmp_path):
    """Restoring step 2 into a state built by init_fn gives the tensors the
    run held after 2 steps; saves beyond three drop the oldest."""
    cfg = loop_runs["split"]
    fns = tstep.make_train_fns(cfg, device="cpu")
    fresh = fns.init_fn(cfg.train.seed)
    ckpt.restore_checkpoint(loop_runs["tmp"] / cfg.name / "checkpoints",
                            fresh, step=2)
    head, tensors = _flat_state(fresh)
    want_head, want = loop_runs["first_sd"]
    assert head == want_head and all(
        torch.equal(a, b) for a, b in zip(tensors, want))
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(tmp_path, fresh, s)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"step_{s:09d}.pt" for s in (2, 3, 4)]
    assert ckpt.latest_step(tmp_path) == 4
    assert ckpt.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path / "none", fresh)


def test_fresh_run_over_a_checkpoint_is_refused(tmp_path):
    """A run that left a checkpoint (and no metrics) blocks a fresh run
    into its results dir unless overwrite, which clears it."""
    cfg = _loop_cfg(tmp_path, "stale", **{"train.steps": 2,
                                          "train.eval_every": 0})
    train_loop(cfg, device="cpu")
    (tmp_path / cfg.name / "metrics.jsonl").unlink()
    with pytest.raises(FileExistsError, match="checkpoint step 2"):
        train_loop(cfg, device="cpu")
    train_loop(cfg, device="cpu", overwrite=True)
    assert ckpt.latest_step(tmp_path / cfg.name / "checkpoints") == 2
