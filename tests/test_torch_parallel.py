"""The port's data parallelism against ``apv_tpu``'s and against itself.

Two gloo ranks on the CPU, spawned once for the module
(``apv_tpu_torch.parallel.dryrun.spawn``), run tiny MNIST train steps, each
rank its half of the global batch with its slice of the global noise
injected (``train_step(noise=)``). The parent (this process, where JAX
runs) holds them to ``apv_tpu``'s single-device ``train_step`` on the
whole batch with the same noise, at the one-step parity tests' bars
(``tests/test_torch_train.py``), and to the port's own one-process step
to float reassociation; the two replicas must hold the same bits. The
configs are the four of ``tests/test_parallel.py`` (plain, adversarial,
Gaussian base, flow prior, this one with the free-information floor and
the dispersion penalty, whose batch statistics are group means) and
floor_adaptive, plus floor_adaptive with the throttle's factor taken from
the local loss, which must break replica equality. The children import
only torch and the port: this module imports JAX inside the parent's
functions alone, and each child checks that ``jax`` was never imported.

Then: the Batcher's host shards and ``iter_from``; the rounding, row and
agreement rules against the reference's on a grid; a 2-rank
``train_loop`` with validation and checkpoints in which rank 0 alone
writes and a resume continues bit for bit; a group of one that gives the
bits of no group; ``dryrun_multiproc(2)``; the CLI's refusal.
"""

import builtins
import json
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from apv_tpu_torch.data.pipeline import Batcher
from apv_tpu_torch.parallel import multihost
from apv_tpu_torch.parallel.dryrun import dryrun_multiproc, spawn
from apv_tpu_torch.training import step as tstep
from apv_tpu_torch.training.loop import train_loop
from apv_tpu_torch.utils import checkpoint as ckpt
from apv_tpu_torch.utils.config import config_from_dict

torch.set_num_threads(1)

TESTS = str(Path(__file__).resolve().parent)
N_STEPS = 2          # the first G update has lr 0: the second moves θ
BATCH = 8            # global; 4 rows a rank
FLOOR = {"adversarial.d_lr_schedule": "floor_adaptive",
         "adversarial.label_smoothing": 0.1, "adversarial.d_lr": 1e-2}
CASES = {
    "plain": ("mnist_vae", {}),
    "adversarial": ("mnist_advprior", {}),
    "gaussian_base": ("mnist_advprior", {"model.prior": "gaussian"}),
    "flow_prior": ("mnist_advprior", {
        "adversarial.enabled": False, "model.prior": "flow",
        "model.prior_flow_layers": 2, "model.prior_flow_hidden": 8,
        "train.free_bits": 0.05, "train.flow_dispersion_penalty": 2.0}),
    "floor_adaptive": ("mnist_advprior", FLOOR),
}
STEP_KEYS = {"loss", "recon", "kl", "elbo", "grad_norm", "beta"}


# -- the ranks' side (torch and the port only) --------------------------------

def _write_guard(results_dir: str, log: list):
    """Record each file this rank opens for writing under
    ``results_dir``."""
    real = builtins.open

    def guarded(file, mode="r", *a, **kw):
        if any(c in mode for c in "wax") and str(file).startswith(
                results_dir):
            log.append(str(Path(file).relative_to(results_dir)))
        return real(file, mode, *a, **kw)

    def replace(src, dst, *a, **kw):
        if str(dst).startswith(results_dir):
            log.append(str(Path(dst).relative_to(results_dir)))
        return real_replace(src, dst, *a, **kw)

    real_replace = os.replace
    builtins.open = guarded
    os.replace = replace


def _rank_steps(tmp: str) -> None:
    """Each case's steps on this rank's rows, its state saved."""
    rank = multihost.process_index()
    lo, hi = multihost.local_rows(BATCH)
    for name in [*CASES, "floor_local_loss"]:
        src = "floor_adaptive" if name == "floor_local_loss" else name
        case = torch.load(Path(tmp) / f"{src}.pt", weights_only=False)
        cfg = config_from_dict(case["cfg"])
        fns = tstep.make_train_fns(cfg, device="cpu", dtype=torch.float32)
        st = fns.init_fn(cfg.train.seed)
        st.model.load_state_dict(case["model"])
        if st.d is not None:
            st.d.load_state_dict(case["d"])
        real_sync = tstep.sync_d
        if name == "floor_local_loss":
            # the throttle from this rank's own loss: gradients averaged,
            # the losses left local
            tstep.sync_d = lambda grads, losses: multihost.average_(grads)
        metrics = []
        try:
            for t in range(N_STEPS):
                noise = {k: (v[t][:, lo:hi] if k == "z_p" else v[t][lo:hi])
                         for k, v in case["noise"].items()}
                batch = {"image_packed": case["batches"][t][lo:hi]}
                st, m = fns.train_step(st, batch, noise=noise)
                metrics.append({k: float(v) for k, v in m.items()})
        finally:
            tstep.sync_d = real_sync
        torch.save({"state": st.state_dict(), "metrics": metrics,
                    "params": [n for n, _ in st.model.named_parameters()]},
                   Path(tmp) / f"{name}.rank{rank}.pt")
    _no_jax()


def _rank_loop(tmp: str) -> None:
    """A 2-rank train_loop to step 4 with validation and checkpoints,
    resumed to 6, a straight run to 6, and a traced run to 11; each
    rank's writes under the results dir logged."""
    rank = multihost.process_index()
    cfg = config_from_dict(json.loads(
        (Path(tmp) / "loop_cfg.json").read_text()))
    writes: list = []
    results = str(Path(cfg.results_dir))
    _write_guard(results, writes)
    import dataclasses
    train_loop(cfg, max_steps=4, device="cpu")
    resumed = train_loop(cfg, resume=True, device="cpu")
    straight = train_loop(dataclasses.replace(cfg, name="straight"),
                          device="cpu")
    # to step 11, so the profiler window (steps 10-15) opens
    train_loop(dataclasses.replace(cfg, name="traced", train=dataclasses.
                                   replace(cfg.train, steps=11,
                                           eval_every=0,
                                           checkpoint_every=11)),
               trace_dir=str(Path(tmp) / "trace"), device="cpu")
    torch.save({"writes": writes, "resumed": resumed.state_dict(),
                "straight": straight.state_dict()},
               Path(tmp) / f"loop.rank{rank}.pt")
    _no_jax()


def _rank_world1(tmp: str) -> None:
    """A group of one: train_loop and evaluate_nll, saved."""
    from apv_tpu_torch.eval.run import eval_arrays, evaluate_nll
    cfg = config_from_dict(json.loads(
        (Path(tmp) / "loop_cfg.json").read_text()))
    import dataclasses
    cfg = dataclasses.replace(cfg, name="world1")
    st = train_loop(cfg, max_steps=4, device="cpu")
    images = eval_arrays(cfg)["image"]
    res = evaluate_nll(cfg, st.model, st.d, images, per_sample=True,
                       seed=3, device="cpu")
    torch.save({"state": st.state_dict(), "nll": res},
               Path(tmp) / "world1.pt")
    _no_jax()


def _no_jax() -> None:
    if "jax" in sys.modules or "apv_tpu" in sys.modules:
        raise AssertionError("a rank imported jax or apv_tpu")




# -- the parent's side (JAX) --------------------------------------------------

def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jax_noise(cfg, rng_key, step):
    """Step ``step``'s global ε, the penalty's base draw and the critic's
    z_p (apv_tpu/training/step.py's key splits)."""
    import jax
    import jax.numpy as jnp
    z, a = cfg.model.z_dim, cfg.adversarial
    _, k_g, *k_ds = jax.random.split(jax.random.fold_in(rng_key, step),
                                     2 + max(a.n_critic, 1))
    noise = {"eps": _t(jax.random.normal(k_g, (BATCH, z), jnp.float32)),
             "u_disp": _t(jax.random.normal(jax.random.fold_in(k_g, 1),
                                            (BATCH, z), jnp.float32))}
    if a.enabled:
        noise["z_p"] = _t(jnp.stack([
            jax.random.normal(jax.random.split(k)[1], (BATCH, z),
                              jnp.float32) for k in k_ds[:a.n_critic]]))
    return noise


def _prepare(name: str, params, z_dim: int):
    """Move a trained prior off its zero init, so every term has a
    gradient (tests/test_torch_priors.py), and shift the posterior mean of
    the floor-adaptive case by 2 (tests/test_torch_knobs.py)."""
    import jax
    import jax.numpy as jnp
    params = jax.tree.map(lambda a: a, params)
    key = jax.random.PRNGKey
    if "gaussian_prior" in params:
        gp = params["gaussian_prior"]
        gp["mu"] = 0.3 * jax.random.normal(key(5), (z_dim,))
        gp["log_sigma"] = 0.2 * jax.random.normal(key(6), (z_dim,))
    if "flow_prior" in params:
        flow = params["flow_prior"]["flow"]
        for i, layer in enumerate(flow["layers"]):
            k1, k2 = jax.random.split(key(10 + i))
            layer["w3"] = 0.05 * jax.random.normal(k1, layer["w3"].shape)
            layer["b3"] = 0.05 * jax.random.normal(k2, layer["b3"].shape)
        flow["whiten"]["mean"] = 0.1 * jnp.ones((z_dim,))
    if name == "floor_adaptive":
        head = params["encoder"]["gaussian_head"]
        head["bias"] = head["bias"].at[:z_dim].set(2.0)
    return params


def _jax_init(fns, key):
    """``fns.init_fn``'s TrainState without running it (its eager init
    compiles one XLA program an initializer call): the structure from
    ``jax.eval_shape``, seeded normal kernels at 1/√fan-in, unit norm
    scales, zero vectors, zero optimizer states and the init's own
    ``rng``. Both sides start from these weights, so their law does not
    matter."""
    import jax
    rng = np.random.default_rng(0)
    a = jax.eval_shape(fns.init_fn, key)

    def zeros(s):
        return np.zeros(s.shape, s.dtype)

    def param(path, s):
        if getattr(path[-1], "key", None) == "scale":
            return np.ones(s.shape, s.dtype)
        if len(s.shape) < 2:
            return zeros(s)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(s.dtype)

    return jax.tree.map(jax.numpy.asarray, a.replace(
        step=zeros(a.step), rng=np.asarray(jax.random.split(key, 3)[2]),
        params=jax.tree_util.tree_map_with_path(param, a.params),
        d_params=jax.tree_util.tree_map_with_path(param, a.d_params),
        opt_state=jax.tree.map(zeros, a.opt_state),
        d_opt_state=jax.tree.map(zeros, a.d_opt_state),
        ema_params=jax.tree.map(zeros, a.ema_params)))


def _jax_case(name: str, tmp: Path):
    """Write a case's initial weights, batches and global noise for the
    ranks; return the function that runs JAX's steps on the global batch
    (its first call compiles) and returns what the ranks are held to."""
    import jax
    import jax.numpy as jnp
    from conftest import tiny_config
    from apv_tpu.data.preprocess import pack_bits
    from apv_tpu.models import registry as jregistry
    from apv_tpu.training import step as jstep
    from apv_tpu_torch.convert import d_params_from_flax, params_from_flax

    preset, extra = CASES[name]
    cfg_j = tiny_config(preset, **{"train.batch_size": BATCH,
                                   "train.beta_warmup_steps": 2, **extra})
    rng = np.random.default_rng(1)
    h, w, c = cfg_j.model.image_shape
    batches = [pack_bits((rng.random((BATCH, h, w, c)) < 0.3)
                         .astype(np.uint8)) for _ in range(N_STEPS)]
    np_tree = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "build_model", lambda mc: jregistry.build_model(
            mc).clone(dtype=jnp.float32))
        fns = jstep.make_train_fns(cfg_j)
    s0 = _jax_init(fns, jax.random.PRNGKey(0))
    s0 = s0.replace(params=_prepare(name, s0.params, cfg_j.model.z_dim))
    step = jax.jit(fns.train_step)
    if name == "floor_adaptive":
        # D trained against the frozen G until its loss stands below
        # chance, so the factors lie inside (0, 1)
        sat = s0
        for _ in range(25):
            sat, _ = step(sat, {"image_packed": batches[0]})
            sat = sat.replace(params=s0.params)
        s0 = s0.replace(d_params=sat.d_params)
    case = {"cfg": json.loads(cfg_j.to_json()),
            "model": params_from_flax(np_tree(s0.params)),
            "d": (d_params_from_flax(np_tree(s0.d_params))
                  if cfg_j.adversarial.enabled else None),
            "batches": [torch.from_numpy(b) for b in batches],
            "noise": {}}
    for t in range(N_STEPS):
        for k, v in _jax_noise(cfg_j, s0.rng, t).items():
            case["noise"].setdefault(k, []).append(v)
    torch.save(case, tmp / f"{name}.pt")

    def run() -> dict:
        state, metrics = s0, []
        for t in range(N_STEPS):
            state, m = step(state, {"image_packed": batches[t]})
            metrics.append({k: float(v) for k, v in m.items()})
        return {"metrics": metrics,
                "params0": params_from_flax(np_tree(s0.params)),
                "params": params_from_flax(np_tree(state.params)),
                "mu": params_from_flax(np_tree(state.opt_state[1][0].mu))}

    return run


def _port_one_process(case: dict):
    """The port's own steps of a case in this process, on the whole
    batch."""
    cfg = config_from_dict(case["cfg"])
    fns = tstep.make_train_fns(cfg, device="cpu", dtype=torch.float32)
    st = fns.init_fn(cfg.train.seed)
    st.model.load_state_dict(case["model"])
    if st.d is not None:
        st.d.load_state_dict(case["d"])
    metrics = []
    for t in range(N_STEPS):
        st, m = fns.train_step(
            st, {"image_packed": case["batches"][t]},
            noise={k: v[t] for k, v in case["noise"].items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return st.state_dict(), metrics


def _loop_cfg(tmp: Path):
    from conftest import tiny_config
    cfg_j = tiny_config("mnist_advprior", tmp_dir=str(tmp / "results"), **{
        "train.batch_size": BATCH, "train.steps": 6, "train.eval_every": 2,
        "train.checkpoint_every": 2, "train.log_every": 1,
        "data.synthetic_size": 96})
    (tmp / "loop_cfg.json").write_text(cfg_j.to_json())
    return config_from_dict(json.loads(cfg_j.to_json()))


class _Background(threading.Thread):
    """A call run beside the parent's JAX work; ``result()`` re-raises its
    failure."""

    def __init__(self, fn, *args, **kw):
        super().__init__(daemon=True)
        self.call, self.out, self.err = (fn, args, kw), None, None
        self.start()

    def run(self):
        fn, args, kw = self.call
        try:
            self.out = fn(*args, **kw)
        except BaseException as e:       # handed to the test that waits
            self.err = e

    def result(self):
        self.join()
        if self.err is not None:
            raise self.err
        return self.out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    cfg = _loop_cfg(tmp)
    # the runs that need no JAX start first, in their own processes
    loop = _Background(spawn, 2, "test_torch_parallel:_rank_loop", str(tmp),
                       device="cpu", paths=(TESTS,))
    world1 = _Background(spawn, 1, "test_torch_parallel:_rank_world1",
                         str(tmp), device="cpu", paths=(TESTS,))
    dry = _Background(dryrun_multiproc, 2, device="cpu")
    fails = _Background(spawn, 2, "test_torch_parallel:_rank_fails",
                        device="cpu", paths=(TESTS,))
    jax_steps = {name: _jax_case(name, tmp) for name in CASES}
    stepping = _Background(spawn, 2, "test_torch_parallel:_rank_steps",
                           str(tmp), device="cpu", paths=(TESTS,))
    # the cases' steps compile one XLA program each: side by side
    with ThreadPoolExecutor(len(jax_steps)) as pool:
        jax_runs = {name: pool.submit(run)
                    for name, run in jax_steps.items()}
        jax_runs = {name: f.result() for name, f in jax_runs.items()}
    stepping.result()
    loop.result()
    world1.result()
    load = lambda p: torch.load(tmp / p, weights_only=False)  # noqa: E731
    ranks = {name: [load(f"{name}.rank{r}.pt") for r in range(2)]
             for name in [*CASES, "floor_local_loss"]}
    return {"tmp": tmp, "jax": jax_runs, "ranks": ranks, "cfg": cfg,
            "one": {name: _port_one_process(load(f"{name}.pt"))
                    for name in CASES},
            "loop": [load(f"loop.rank{r}.pt") for r in range(2)],
            "world1": load("world1.pt"), "dryrun": dry, "fails": fails}


def _flat(sd) -> list[torch.Tensor]:
    """Every tensor of a TrainState.state_dict(), in one order."""
    out = [*sd["model"].values()]
    for o in ("opt", "d_opt"):
        if o in sd:
            out += [*sd[o]["mu"], *sd[o]["nu"], *sd[o].get("acc", [])]
    if "d" in sd:
        out += [*sd["d"].values()]
    return out


def _states_equal(a, b) -> bool:
    ta, tb = _flat(a), _flat(b)
    return (a["step"] == b["step"] and len(ta) == len(tb)
            and all(torch.equal(x, y) for x, y in zip(ta, tb)))


def _group_metrics(name: str, runs) -> list[dict]:
    """The two ranks' step metrics averaged, as the loop logs them: each
    rank's are means over its half of the batch (grad_norm and the
    throttle's factors are already the group's)."""
    r0, r1 = (r["metrics"] for r in runs["ranks"][name])
    return [{k: (a[k] + b[k]) / 2 for k in a} for a, b in zip(r0, r1)]


def _scale_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("name", list(CASES))
def test_replicas_hold_the_same_bits(runs, name):
    r0, r1 = runs["ranks"][name]
    assert _states_equal(r0["state"], r1["state"])
    assert r0["state"]["step"] == N_STEPS


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_step_matches_jax_global_batch(runs, name):
    """Metrics element-wise at rtol 1e-4 / atol 1e-3 (d_acc within one
    logit of 2·B), Adam's first moments ≤ 1e-3 and Δθ ≤ 1e-2 scale-relative
    per tensor: the bars of tests/test_torch_train.py."""
    got = runs["ranks"][name][0]
    want = runs["jax"][name]
    group = _group_metrics(name, runs)
    for t in range(N_STEPS):
        g, w = group[t], want["metrics"][t]
        assert set(g) == set(w) and STEP_KEYS <= set(g)
        for k in w:
            if k.endswith("acc"):
                assert abs(g[k] - w[k]) <= 0.5 / BATCH + 1e-7, (k, g, w)
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-3,
                                           err_msg=f"{name} step {t} {k}")
    sd = got["state"]
    mu = dict(zip(got["params"], sd["opt"]["mu"]))
    assert set(mu) == set(want["mu"])
    assert max(_scale_rel(mu[k], want["mu"][k]) for k in want["mu"]) <= 1e-3
    worst = max(_scale_rel(sd["model"][k] - want["params0"][k],
                           want["params"][k] - want["params0"][k])
                for k in want["params"] if float(
                    (want["params"][k] - want["params0"][k]).abs().max()) > 0)
    assert worst <= 1e-2, worst


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_step_matches_one_process_port(runs, name):
    """Against the port's own step on the whole batch: the same math with
    each batch mean taken as the mean of two half-batch means, so float
    reassociation only: metrics to rtol 1e-5 (atol 1e-4 on the nat-sized
    sums), every state tensor (parameters, both Adams' moments) ≤ 1e-3
    scale-relative (Adam's 1/√v̂ amplifies the last bits of tiny
    gradients, as in the JAX bars)."""
    got = runs["ranks"][name][0]
    group = _group_metrics(name, runs)
    sd_one, m_one = runs["one"][name]
    for t in range(N_STEPS):
        for k, v in m_one[t].items():
            np.testing.assert_allclose(group[t][k], v, rtol=1e-5,
                                       atol=1e-4, err_msg=f"{name} {t} {k}")
    for a, b in zip(_flat(got["state"]), _flat(sd_one)):
        assert _scale_rel(a, b) <= 1e-3


def test_local_loss_throttle_breaks_replica_equality(runs):
    """floor_adaptive with each rank's factor from its own half batch's D
    loss: the factors differ, so the D replicas drift apart at once (the
    group mean keeps them equal: test_replicas_hold_the_same_bits)."""
    r0, r1 = runs["ranks"]["floor_local_loss"]
    f0 = [m["d_lr_factor"] for m in r0["metrics"]]
    f1 = [m["d_lr_factor"] for m in r1["metrics"]]
    assert f0 != f1 and all(0.0 < f < 1.0 for f in f0 + f1)
    assert not all(torch.equal(a, b) for a, b in zip(
        r0["state"]["d"].values(), r1["state"]["d"].values()))


# -- the loop: rank 0 writes alone, resume, a group of one --------------------

def test_rank0_alone_writes(runs):
    w0, w1 = (r["writes"] for r in runs["loop"])
    assert w1 == []
    names = set(w0)
    assert {"mnist_advprior/config.json", "mnist_advprior/best.json",
            "mnist_advprior/metrics.jsonl",
            "straight/metrics.jsonl"} <= names
    assert any(n.startswith("mnist_advprior/checkpoints/step_") for n in w0)
    assert any(n.startswith("mnist_advprior/best/step_") for n in w0)


def test_metrics_have_one_record_a_step(runs):
    path = Path(runs["cfg"].results_dir) / "mnist_advprior" / "metrics.jsonl"
    records = [json.loads(x) for x in path.read_text().splitlines()]
    train = [r["step"] for r in records if "loss" in r]
    valid = [r["step"] for r in records if "valid_elbo" in r]
    assert train == list(range(6)) and valid == [2, 4, 6]
    assert all(r["images_per_sec"] == 2 * r["images_per_sec_per_chip"]
               for r in records if "images_per_sec" in r)
    assert ckpt.latest_step(path.parent / "checkpoints") == 6
    assert json.loads((path.parent / "best.json").read_text())["step"] in (
        2, 4, 6)


def test_each_rank_writes_its_own_trace(runs):
    """Under a group every rank exports its profiler window to a file of
    its own: no two ranks write one path."""
    trace = runs["tmp"] / "trace"
    names = sorted(p.name for p in trace.iterdir())
    assert names == ["trace_steps_10-15.rank0.json",
                     "trace_steps_10-15.rank1.json"]
    for name in names:
        assert json.loads((trace / name).read_text())["traceEvents"]


def test_resume_continues_exactly(runs):
    for r in runs["loop"]:
        assert _states_equal(r["resumed"], r["straight"])
    assert _states_equal(runs["loop"][0]["resumed"],
                         runs["loop"][1]["resumed"])


def test_group_of_one_gives_the_bits_of_no_group(runs, tmp_path):
    """A group of one runs every collective and folds no rank into the
    noise: the same train_loop and evaluate_nll without a group give the
    same bits."""
    import dataclasses
    from apv_tpu_torch.eval.run import eval_arrays, evaluate_nll
    cfg = dataclasses.replace(runs["cfg"], name="nogroup",
                              results_dir=str(tmp_path))
    st = train_loop(cfg, max_steps=4, device="cpu")
    assert _states_equal(st.state_dict(), runs["world1"]["state"])
    res = evaluate_nll(cfg, st.model, st.d, eval_arrays(cfg)["image"],
                       per_sample=True, seed=3, device="cpu")
    np.testing.assert_array_equal(res["per_sample"],
                                  runs["world1"]["nll"]["per_sample"])
    assert res["log_partition"] == runs["world1"]["nll"]["log_partition"]


# -- the host-side rules against the reference's ------------------------------

@pytest.mark.parametrize("shuffle", [True, False])
def test_batcher_host_shards_concatenate_to_global(shuffle):
    """Each rank's rows of every batch, and of the stream fast-forwarded
    by iter_from, concatenate to the one-process batch, which is the
    reference's (tests/test_parallel.py:110-132)."""
    from apv_tpu.data import Batcher as JBatcher
    arrays = {"image": np.arange(64 * 4, dtype=np.float32).reshape(64, 4)}
    whole = Batcher(arrays, 16, seed=3, shuffle=shuffle)
    ref = JBatcher(arrays, 16, seed=3, shuffle=shuffle)
    parts = [Batcher(arrays, 16, seed=3, shuffle=shuffle, host_shard=(p, 2))
             for p in range(2)]
    for b_all, b_ref, b0, b1 in zip(whole.epoch(), ref.epoch(),
                                    parts[0].epoch(), parts[1].epoch()):
        assert b0["image"].shape == (8, 4)
        np.testing.assert_array_equal(b_all["image"], b_ref["image"])
        np.testing.assert_array_equal(
            np.concatenate([b0["image"], b1["image"]]), b_all["image"])
    ref_from = JBatcher(arrays, 16, seed=3, shuffle=shuffle).iter_from(6)
    its = [Batcher(arrays, 16, seed=3, shuffle=shuffle,
                   host_shard=(p, 2)).iter_from(6) for p in range(2)]
    for _ in range(7):
        np.testing.assert_array_equal(
            np.concatenate([next(it)["image"] for it in its]),
            next(ref_from)["image"])


def test_batcher_host_shard_validation():
    arrays = {"image": np.zeros((32, 2), np.float32)}
    with pytest.raises(ValueError, match="divisible"):
        Batcher(arrays, 10, host_shard=(0, 3))
    with pytest.raises(ValueError, match="host_shard"):
        Batcher(arrays, 8, host_shard=(2, 2))


@pytest.mark.parametrize("bs,pcount,n_shards", [
    (256, 1, 1), (256, 2, 1), (255, 2, 1), (100, 3, 4), (7, 4, 1),
    (64, 1, 8), (30, 4, 6), (1, 2, 2)])
def test_round_global_batch_matches_reference(bs, pcount, n_shards):
    from apv_tpu.parallel.multihost import round_global_batch as jround
    assert multihost.round_global_batch(bs, pcount, n_shards) == jround(
        bs, pcount, n_shards)


@pytest.mark.parametrize("n,pid,pcount", [(16, 0, 1), (16, 1, 2),
                                          (24, 2, 3), (10, 0, 3)])
def test_local_rows_matches_reference(n, pid, pcount):
    from apv_tpu.parallel.multihost import local_rows as jlocal
    try:
        want = jlocal(n, pid, pcount)
    except ValueError:
        with pytest.raises(ValueError, match="divisible"):
            multihost.local_rows(n, pid, pcount)
        return
    assert multihost.local_rows(n, pid, pcount) == want


@pytest.mark.parametrize("value", [None, 0, 7])
def test_agree_max_single_process_matches_reference(value):
    from apv_tpu.parallel.multihost import agree_max as jagree
    assert multihost.agree_max(value) == jagree(value) == value
    assert multihost.host_shard() is None


def test_dryrun_multiproc_two_ranks(runs):
    out = runs["dryrun"].result()
    for label in ("plain", "steps_per_call=2", "device_resident",
                  "biadversarial step", "iwae/dreg objective step",
                  "spectral-norm D step", "gaussian-base prior step",
                  "trained flow prior step", "k-sharded IWAE",
                  "k-sharded flow-prior IWAE"):
        assert f"dryrun {label}" in out, out


def test_ranks_run_on_the_card_unless_the_cpu_is_named():
    """Like every entry point, the dry run and its ranks take the card by
    default: without one they raise before any rank starts."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multiproc(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spawn(2, "test_torch_parallel:_rank_fails", paths=(TESTS,))


def test_spawn_fails_when_a_rank_fails(runs):
    with pytest.raises(RuntimeError, match="exit codes"):
        runs["fails"].result()


def _rank_fails() -> None:
    if multihost.process_index() == 1:
        raise ValueError("rank 1 fails")
    multihost.barrier()


def test_cli_distributed_needs_a_coordinator(monkeypatch):
    from apv_tpu_torch import cli
    monkeypatch.delenv("APV_COORDINATOR", raising=False)
    with pytest.raises(SystemExit,
                       match="--distributed set but APV_COORDINATOR unset"):
        cli.main(["train", "--distributed", "--device", "cpu"])


def test_state_tensors_cover_the_checkpoint(runs):
    """The dry run's replica check reads every tensor a checkpoint holds."""
    st = tstep.make_train_fns(runs["cfg"], device="cpu").init_fn(0)
    assert len(st.tensors()) == len(_flat(st.state_dict()))
