"""The reference's orbax checkpoints read by the port.

``apv_tpu`` trains a few steps of four tiny runs (float32 flax models,
patched in here) and saves each with its own ``save_checkpoint`` into
``<tmp>/results/<name>/checkpoints`` beside its ``config.json``:

* ``mnist_advprior``: the latent D and its optimizer;
* ``cifar_advprior_resnet`` with ``train.ema_decay`` and
  ``train.grad_accum=2``, stopped inside a window: ConvTranspose layers,
  the EMA shadow and optax's ``MultiStepsState``;
* ``cifar_flow``: the trained flow prior's tree;
* ``pre_ema``: the first run's state saved without its ``ema_params``
  field, as checkpoints written before the shadow existed are.

The port lists them (``api.info``), restores them (every tensor equal to
the converted reference tree), scores them (the per-sample ELBO with
JAX's ε injected, at the scorer tests' tolerance), resumes them (one step
from the restored state against ``make_train_fns``'s step from the saved
one, with JAX's noise injected) and writes them as ``.pt`` files
(``import_orbax``).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from apv_tpu import serving as jserving
from apv_tpu.data.preprocess import pack_bits
from apv_tpu.models import build_model as jbuild
from apv_tpu.ops import dispatch as jdispatch
from apv_tpu.training import step as jstep
from apv_tpu.training.state import eval_params
from apv_tpu.utils import checkpoint as jckpt
from apv_tpu_torch import api
from apv_tpu_torch.convert import (adam_from_optax, d_params_from_flax,
                                   params_from_flax)
from apv_tpu_torch.serving import make_scorer
from apv_tpu_torch.training import step as tstep
from apv_tpu_torch.utils import checkpoint as ckpt
from apv_tpu_torch.utils.config import config_from_dict

torch.set_num_threads(1)

B = 8
RUNS = {
    # name: (preset, overrides, steps before the save)
    "mnist_advprior": ("mnist_advprior", {}, 2),
    "cifar_advprior_resnet": ("cifar_advprior_resnet",
                              {"train.ema_decay": 0.9,
                               "train.grad_accum": 2}, 3),
    "cifar_flow": ("cifar_flow", {}, 2),
}
CASES = list(RUNS) + ["pre_ema"]


def _f32(mc):
    return jbuild(mc).clone(dtype=jnp.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (B, *cfg.model.image_shape)
    if cfg.data.binarize:
        return {"image_packed": pack_bits(
            (rng.random(shape) < 0.3).astype(np.uint8))}
    return {"image": rng.integers(0, 256, shape, dtype=np.uint8)}


def _jax_noise(cfg, rng_key, step, shape):
    """Step ``step``'s draws by the reference's key splits: the
    dequantization u (CIFAR), G's ε and the critic's z_p
    (apv_tpu/training/step.py)."""
    z = cfg.model.z_dim
    k_deq, k_g, *k_ds = jax.random.split(jax.random.fold_in(rng_key, step),
                                         2 + max(cfg.adversarial.n_critic, 1))
    t = lambda a: torch.from_numpy(np.array(a))           # noqa: E731
    noise = {"eps": t(jax.random.normal(k_g, (shape[0], z), jnp.float32))}
    if not cfg.data.binarize:
        noise["u"] = t(jax.random.uniform(k_deq, shape, dtype=jnp.float32))
    if cfg.adversarial.enabled:
        noise["z_p"] = t(jnp.stack([
            jax.random.normal(jax.random.split(k)[1], (shape[0], z),
                              jnp.float32)
            for k in k_ds[:cfg.adversarial.n_critic]]))
    return noise


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Each case: its JAX config, its saved state, the JAX state and
    metrics one step later, and the batch of that step."""
    root = tmp_path_factory.mktemp("orbax")
    results = root / "results"
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "build_model", _f32)
        for name, (preset, over, steps) in RUNS.items():
            cfg = tiny_config(preset, **{"name": name, "results_dir":
                                         str(results),
                                         "train.batch_size": B, **over})
            fns = jstep.make_train_fns(cfg)
            step = jax.jit(fns.train_step)
            state = jax.jit(fns.init_fn)(jax.random.PRNGKey(0))
            for t in range(steps):
                state, _ = step(state, _batch(cfg, t))
            run = results / name
            jckpt.save_checkpoint(run / "checkpoints",
                                  jax.device_get(state), steps)
            (run / "config.json").write_text(
                json.dumps(dataclasses.asdict(cfg)))
            batch = _batch(cfg, steps)
            after, met = step(state, batch)
            out[name] = dict(cfg=cfg, state=state, after=after, batch=batch,
                             metrics={k: float(v) for k, v in met.items()},
                             step=steps)
    src = out["mnist_advprior"]
    old_style = {f.name: getattr(src["state"], f.name)
                 for f in dataclasses.fields(src["state"])
                 if f.name != "ema_params"}
    run = results / "pre_ema"
    jckpt.save_checkpoint(run / "checkpoints", jax.device_get(old_style),
                          src["step"])
    cfg = dataclasses.replace(src["cfg"], name="pre_ema")
    (run / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    out["pre_ema"] = dict(src, cfg=cfg)
    return results, out


def _port_cfg(cfg_j, **over):
    cfg = config_from_dict(json.loads(cfg_j.to_json()))
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **over))


def _port_state(cfg_t):
    """A float32 CPU state of the run's config, the orbax step copied in."""
    fns = tstep.make_train_fns(cfg_t, device="cpu", dtype=torch.float32)
    state = fns.init_fn(cfg_t.train.seed)
    ckpt.restore_checkpoint(Path(cfg_t.results_dir) / cfg_t.name
                            / "checkpoints", state)
    return fns, state


def _assert_tensors_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _opt_want(tree_opt, module, convert):
    return adam_from_optax(_np_tree(tree_opt), module, convert)


@pytest.mark.parametrize("case", CASES)
def test_info_lists_orbax_steps(ref, case):
    results, out = ref
    listed = api.info(case, results_dir=str(results))
    assert listed["checkpoint_steps"] == [out[case]["step"]]
    assert listed["latest_checkpoint"] == out[case]["step"]
    runs = api.info(results_dir=str(results))["runs"]
    assert {r["name"]: r["latest_checkpoint"] for r in runs}[case] == \
        out[case]["step"]
    assert ckpt.latest_step(results / case / "checkpoints") == \
        out[case]["step"]


@pytest.mark.parametrize("case", CASES)
def test_restored_tensors_equal_the_converted_tree(ref, case):
    """Through ``api._restore_state``, the path of every eval-side entry
    point (the preset's own compute dtype; parameters and moments are
    float32 either way)."""
    results, out = ref
    o = out[case]
    cfg_t = api._adopt_checkpoint_arch(_port_cfg(o["cfg"]), None)
    state = api._restore_state(cfg_t, device="cpu")
    s = o["state"]
    assert state.step == o["step"] and state.seed == cfg_t.train.seed
    _assert_tensors_equal(state.model.state_dict(),
                          params_from_flax(_np_tree(s.params)))
    want = _opt_want(s.opt_state, state.model, params_from_flax)
    got = state.opt.state_dict()
    assert got["count"] == want["count"]
    for key in ("mu", "nu") + (("acc",) if "acc" in want else ()):
        assert all(torch.equal(a, b) for a, b in zip(got[key], want[key]))
    if "mini_step" in want:
        assert got["mini_step"] == want["mini_step"] == 1
    if cfg_t.adversarial.enabled:
        _assert_tensors_equal(state.d.state_dict(),
                              d_params_from_flax(_np_tree(s.d_params)))
        dwant = _opt_want(s.d_opt_state, state.d, d_params_from_flax)
        assert all(torch.equal(a, b) for a, b in
                   zip(state.d_opt.state_dict()["nu"], dwant["nu"]))
    if cfg_t.train.ema_decay > 0:
        _assert_tensors_equal(state.ema_model.state_dict(),
                              params_from_flax(_np_tree(s.ema_params)))
    else:
        assert state.ema_model is None


@pytest.mark.parametrize("want_ema", [False, True])
def test_pre_ema_tree_follows_the_config(ref, want_ema):
    """A tree without ``ema_params`` seeds a wanted shadow from the
    restored parameters; a config without one drops nothing it needs."""
    results, out = ref
    o = out["pre_ema"]
    cfg_t = _port_cfg(o["cfg"], ema_decay=0.5 if want_ema else 0.0)
    _, state = _port_state(cfg_t)
    want = params_from_flax(_np_tree(o["state"].params))
    _assert_tensors_equal(state.model.state_dict(), want)
    if want_ema:
        _assert_tensors_equal(state.ema_model.state_dict(), want)
    else:
        assert state.ema_model is None


def test_saved_shadow_is_dropped_by_a_config_without_one(ref):
    results, out = ref
    o = out["cifar_advprior_resnet"]
    _, state = _port_state(_port_cfg(o["cfg"], ema_decay=0.0))
    assert state.ema_model is None
    _assert_tensors_equal(state.model.state_dict(),
                          params_from_flax(_np_tree(o["state"].params)))


def _x_levels(cfg, batch):
    if cfg.data.binarize:
        from apv_tpu.data.preprocess import unpack_bits
        return np.asarray(unpack_bits(batch["image_packed"],
                                      cfg.model.image_shape), np.float32)
    return batch["image"].astype(np.float32) / 255.0


@pytest.mark.parametrize("case", CASES)
def test_elbo_matches_the_reference_scorer(ref, case, monkeypatch):
    """The reference's ``_scorer_fn`` (the jnp tier) against the port's
    ``make_scorer`` on the restored state, JAX's ε injected, under each
    run's own prior and its EMA shadow where it has one."""
    results, out = ref
    o = out[case]
    cfg_j = o["cfg"]
    x = _x_levels(cfg_j, o["batch"])
    monkeypatch.setattr(jserving, "build_model", _f32)
    params = eval_params(o["state"], cfg_j)
    d_params = o["state"].d_params if cfg_j.adversarial.enabled else None
    with jdispatch.backend("jnp"):
        want = np.asarray(jax.jit(jserving._scorer_fn(
            cfg_j, params, d_params, 0.0))(jnp.asarray(x), 11))
    eps = np.array(jax.random.normal(jax.random.PRNGKey(11),
                                     (B, cfg_j.model.z_dim), jnp.float32))
    cfg_t = _port_cfg(cfg_j)
    _, state = _port_state(cfg_t)
    scorer = make_scorer(cfg_t, api._p(state, cfg_t), api._d(state, cfg_t),
                         0.0, device="cpu")
    got = scorer(torch.from_numpy(x), eps=torch.from_numpy(eps)).numpy()
    assert got.shape == (B,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-2)


def _scale_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("case", list(RUNS))
def test_resumed_step_matches_the_reference(ref, case):
    """One step from the restored state against ``make_train_fns``'s step
    from the saved state, JAX's noise injected: the metrics at
    ``rtol=1e-4, atol=1e-3`` (tests/test_torch_train.py), then what the
    carried optimizer made of them: Adam's first moments scale-relative
    ≤ 1e-3 and the parameters' change ≤ 1e-2 (the bars of
    tests/test_torch_train.py), the shadow likewise."""
    results, out = ref
    o = out[case]
    cfg_j, s0, s1 = o["cfg"], o["state"], o["after"]
    cfg_t = _port_cfg(cfg_j)
    fns, state = _port_state(cfg_t)
    p0 = {k: v.clone() for k, v in state.model.state_dict().items()}
    shape = (B, *cfg_j.model.image_shape)
    batch = {k: torch.from_numpy(v) for k, v in o["batch"].items()}
    state, met = fns.train_step(
        state, batch, noise=_jax_noise(cfg_j, s0.rng, o["step"], shape))
    got = {k: float(v) for k, v in met.items()}
    assert state.step == o["step"] + 1
    for k, want in o["metrics"].items():
        if k == "d_acc":
            assert abs(got[k] - want) <= 0.5 / B + 1e-7, (k, got[k], want)
        else:
            np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-3,
                                       err_msg=k)
    mu = _opt_want(s1.opt_state, state.model, params_from_flax)
    assert state.opt.count == mu["count"]
    assert max(_scale_rel(a, b) for a, b in zip(state.opt.mu, mu["mu"])
               if b.abs().max() > 0) <= 1e-3
    want1 = params_from_flax(_np_tree(s1.params))
    want0 = params_from_flax(_np_tree(s0.params))
    now = state.model.state_dict()
    moved = [k for k in want1 if not torch.equal(want1[k], want0[k])]
    assert moved and max(_scale_rel(now[k] - p0[k], want1[k] - want0[k])
                         for k in moved) <= 1e-2
    if cfg_t.train.ema_decay > 0:
        ema1 = params_from_flax(_np_tree(s1.ema_params))
        ema0 = params_from_flax(_np_tree(s0.ema_params))
        now = state.ema_model.state_dict()
        assert max(_scale_rel(now[k] - ema0[k], ema1[k] - ema0[k])
                   for k in moved) <= 1e-2


@pytest.mark.parametrize("case", CASES)
def test_import_orbax_writes_pt_files_that_restore_the_same(ref, case,
                                                            tmp_path):
    import shutil
    results, out = ref
    o = out[case]
    run = tmp_path / case
    shutil.copytree(results / case, run)
    cfg_t = _port_cfg(o["cfg"])
    cfg_t = dataclasses.replace(cfg_t, results_dir=str(tmp_path))
    _, from_orbax = _port_state(cfg_t)
    written = ckpt.import_orbax(run / "checkpoints")
    assert [p.name for p in written] == [f"step_{o['step']:09d}.pt"]
    # the .pt file wins where both formats hold the step: without the
    # orbax directory it restores alone, to the same tensors
    shutil.rmtree(run / "checkpoints" / str(o["step"]))
    _, from_pt = _port_state(cfg_t)
    a, b = from_orbax.state_dict(), from_pt.state_dict()
    assert a["step"] == b["step"] and a["seed"] == b["seed"]
    for part in ("model", "d", "ema_model"):
        if part in a:
            _assert_tensors_equal(b[part], a[part])
    for key in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(a["opt"][key],
                                                     b["opt"][key]))


def test_resume_writes_pt_beside_the_orbax_steps(ref, tmp_path):
    """``api.train(resume=True)`` continues a reference run: the next save
    is a ``.pt`` file beside the orbax directory, which stays."""
    import shutil
    results, out = ref
    run = tmp_path / "mnist_advprior"
    shutil.copytree(results / "mnist_advprior", run)
    step = out["mnist_advprior"]["step"]
    state = api.train("mnist_advprior", resume=True, max_steps=1,
                      device="cpu", overrides=[
                          f"results_dir={tmp_path}", "data.synthetic_size=64",
                          f"train.batch_size={B}",
                          "train.steps_per_call=1", "train.steps=60",
                          "train.log_every=1000", "train.eval_every=0"])
    assert state.step == step + 1
    ckpts = run / "checkpoints"
    assert (ckpts / str(step)).is_dir()
    assert (ckpts / f"step_{step + 1:09d}.pt").exists()
    assert ckpt.latest_step(ckpts) == step + 1
    assert api.info("mnist_advprior",
                    results_dir=str(tmp_path))["checkpoint_steps"] == \
        [step, step + 1]


@pytest.mark.parametrize("ocdbt", [True, False])
def test_reader_rebuilds_the_tree_in_both_layouts(tmp_path, ocdbt):
    """A tree of dicts, a tuple holding None and arrays of three dtypes,
    saved by orbax with and without OCDBT (the plain ``file`` kvstore),
    read back unchanged."""
    import orbax.checkpoint as ocp
    tree = {"step": np.int32(3),
            "params": {"a": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "opt": (None, {"count": np.int32(1),
                           "key": np.array([7, 9], np.uint32)})}
    with ocp.CheckpointManager(
            tmp_path.absolute(),
            item_handlers=ocp.PyTreeCheckpointHandler(use_ocdbt=ocdbt),
            options=ocp.CheckpointManagerOptions(create=True)) as mngr:
        mngr.save(3, args=ocp.args.PyTreeSave(tree))
        mngr.wait_until_finished()
    assert (tmp_path / "3" / "default" / "manifest.ocdbt").exists() == ocdbt
    got = ckpt.read_orbax_tree(tmp_path / "3")
    assert sorted(got) == ["opt", "params", "step"]
    assert int(got["step"]) == 3 and got["opt"][0] is None
    np.testing.assert_array_equal(got["params"]["a"], tree["params"]["a"])
    assert got["opt"][1]["key"].dtype == np.uint32
    np.testing.assert_array_equal(got["opt"][1]["key"], [7, 9])
    assert ckpt.latest_step(tmp_path) == 3


_NO_TENSORSTORE = """
import sys
sys.modules["tensorstore"] = None
import apv_tpu_torch, apv_tpu_torch.api, apv_tpu_torch.serving
import apv_tpu_torch.cli
from apv_tpu_torch.utils import checkpoint as ckpt
from apv_tpu_torch.training.step import make_train_fns
from apv_tpu_torch.utils.config import config_from_dict
import json, pathlib
run = pathlib.Path(sys.argv[1])
cfg = config_from_dict(json.loads((run / "config.json").read_text()))
state = make_train_fns(cfg, device="cpu").init_fn(cfg.train.seed)
ckpt.restore_checkpoint(run / "pt", state)
print("pt", state.step)
try:
    ckpt.restore_checkpoint(run / "checkpoints", state)
except ImportError as e:
    print("refused:", e)
"""


def test_without_tensorstore_pt_restores_and_orbax_is_refused(ref,
                                                              tmp_path):
    results, out = ref
    o = out["mnist_advprior"]
    run = results / "mnist_advprior"
    fns = tstep.make_train_fns(_port_cfg(o["cfg"]), device="cpu")
    state = fns.init_fn(0)
    state.step = 5
    (tmp_path / "pt").mkdir()
    ckpt.save_checkpoint(tmp_path / "pt", state, 5)
    (tmp_path / "config.json").write_text((run / "config.json").read_text())
    os.symlink(run / "checkpoints", tmp_path / "checkpoints")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).parents[1]))
    res = subprocess.run([sys.executable, "-c", _NO_TENSORSTORE,
                          str(tmp_path)], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "pt 5" in res.stdout
    assert "refused:" in res.stdout and "tensorstore" in res.stdout
    assert "import_orbax" in res.stdout
