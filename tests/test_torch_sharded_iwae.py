"""The port's k-sharded IWAE against its unsharded estimator and against
``apv_tpu.eval.sharded.make_sharded_iwae_fn``.

Four gloo ranks on the CPU, spawned once for the module, score a tiny
MNIST conv VAE's batch on rank grids of (1, 2), (1, 4) and (2, 2) ranks
(data × k): the merged estimate equals the port's unsharded
``make_iwae_fn`` with the same generator at the reference's bar (rtol
1e-5, atol 1e-4; ``tests/test_sharded_iwae.py``); handed JAX's chunk noise,
it equals ``make_sharded_iwae_fn`` on JAX's 8 virtual CPU devices under
the standard, the adversarial (log Z given) and an ex-post flow prior;
data shards draw independent noise. ``evaluate_nll`` with
``eval.k_shards=4`` on the four ranks equals the one-process run, a
``k_shards`` that does not divide the ranks is refused, and
``posterior_activity`` gathers what one process computes. Beside them
``dryrun_multiproc(4)`` runs every data-parallel path on four ranks. The
children import only torch and the port; JAX runs here.
"""

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from apv_tpu_torch.eval.iwae_eval import make_iwae_fn
from apv_tpu_torch.eval.run import _eval_batch_size
from apv_tpu_torch.eval.sharded import make_sharded_iwae_fn
from apv_tpu_torch.parallel import multihost
from apv_tpu_torch.parallel.dryrun import dryrun_multiproc, spawn
from apv_tpu_torch.parallel.mesh import RankGrid, make_grid_2d
from apv_tpu_torch.utils.config import config_from_dict
from test_torch_parallel import _Background

torch.set_num_threads(1)

TESTS = str(Path(__file__).resolve().parent)
Z, B, K, CHUNK, SEED = 8, 8, 8, 2, 11
GRIDS = [(1, 2), (1, 4), (2, 2)]
PRIORS = ["standard", "adversarial", "expost_flow"]
# (prior, grid) held to JAX: every prior on the full 2-D grid, and the
# standard prior with one data shard (no fold of the data index)
JAX_CASES = [("standard", (1, 2))] + [(p, (2, 2)) for p in PRIORS]
LOG_Z = 0.3


# -- the ranks' side (torch and the port only) --------------------------------

def _port_parts(case: dict):
    """(model, latent D, ex-post flow) of the port from the payload."""
    from apv_tpu_torch.models import LatentDiscriminator, build_model
    cfg = config_from_dict(case["cfg"])
    model = build_model(cfg.model, dtype=torch.float32, device="cpu")
    model.load_state_dict(case["model"])
    d = LatentDiscriminator(Z, tuple(cfg.adversarial.d_widths))
    d.load_state_dict(case["d"])
    return cfg, model.eval(), d.eval(), case["flow"]


def _prior_kw(prior: str, d, flow) -> dict:
    from apv_tpu_torch.sampling.run import expost_prior_logpdf
    if prior == "adversarial":
        return {"d_apply": d}
    if prior == "expost_flow":
        return {"prior_logpdf": expost_prior_logpdf(flow)}
    return {}


def _rank_sharded(tmp: str) -> None:
    from apv_tpu_torch.eval.run import (eval_arrays, evaluate_nll,
                                        posterior_activity)
    rank, world = multihost.process_index(), multihost.process_count()
    case = torch.load(Path(tmp) / "case.pt", weights_only=False)
    cfg, model, d, flow = _port_parts(case)
    x = case["x"]
    out: dict = {}
    with torch.inference_mode():
        for n_data, n_k in GRIDS:
            grid = make_grid_2d(n_data, n_k)
            if not grid.member:
                continue
            per = B // n_data
            rows = slice(grid.data_index * per, (grid.data_index + 1) * per)
            f = make_sharded_iwae_fn(model, "bernoulli", K, CHUNK, grid)
            out[f"same_gen_{n_data}x{n_k}"] = f(x[rows], x[rows], seed=SEED)
            for prior in [p for p, g in JAX_CASES if g == (n_data, n_k)]:
                f = make_sharded_iwae_fn(model, "bernoulli", K, CHUNK, grid,
                                         **_prior_kw(prior, d, flow))
                eps = case["eps"][(n_data, n_k)][grid.data_index][
                    grid.k_index]
                log_z = LOG_Z if prior == "adversarial" else 0.0
                out[f"jax_{prior}_{n_data}x{n_k}"] = f(
                    x[rows], x[rows], log_z, seed=SEED, eps=eps)
            if (n_data, n_k) == (2, 2):
                x2 = torch.cat([x[:4], x[:4]])
                f = make_sharded_iwae_fn(model, "bernoulli", K, CHUNK, grid)
                out["dup_2x2"] = f(x2[rows], x2[rows], seed=SEED)
    # every rank's dict, gathered to rank 0 through the file system
    images = eval_arrays(cfg)["image"]
    out["evaluate"] = evaluate_nll(
        cfg_k(cfg, 4), model, None, images, k=4 * 10, chunk=10,
        per_sample=True, seed=SEED, device="cpu")["per_sample"]
    try:
        evaluate_nll(cfg_k(cfg, 3), model, None, images, k=30, chunk=10,
                     device="cpu")
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    out["activity"] = posterior_activity(cfg, model, images, device="cpu")
    torch.save(out, Path(tmp) / f"rank{rank}.pt")
    if "jax" in sys.modules or "apv_tpu" in sys.modules:
        raise AssertionError("a rank imported jax or apv_tpu")
    assert world == 4


def cfg_k(cfg, k_shards: int):
    import dataclasses
    return dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, k_shards=k_shards))


# -- the parent's side --------------------------------------------------------

def _filled(tree, seed: int):
    """Seeded weights of a flax init's structure (``jax.eval_shape``, no
    compile): normal kernels at 1/√fan-in, unit scales, zero vectors."""
    import jax
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if getattr(path[-1], "key", None) == "scale":
            return np.ones(s.shape, s.dtype)
        if len(s.shape) < 2:
            return np.zeros(s.shape, s.dtype)
        return (rng.normal(size=s.shape)
                / np.sqrt(np.prod(s.shape[:-1]))).astype(s.dtype)

    return jax.tree.map(jax.numpy.asarray,
                        jax.tree_util.tree_map_with_path(leaf, tree))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from conftest import tiny_config
    from apv_tpu.eval.sharded import make_mesh_2d
    from apv_tpu.eval.sharded import make_sharded_iwae_fn as jsharded
    from apv_tpu.models import registry as jregistry
    from apv_tpu.models.discriminator import LatentDiscriminator as FlaxD
    from apv_tpu.ops import dispatch as jdispatch
    from apv_tpu.sampling.run import expost_prior_logpdf as jexpost
    from apv_tpu_torch.convert import (d_params_from_flax, flow_from_flax,
                                       params_from_flax)
    from apv_tpu.core.flow import init_flow

    tmp = tmp_path_factory.mktemp("sharded")
    cfg_j = tiny_config("mnist_vae", **{"eval.max_examples": 32})
    fmodel = jregistry.build_model(cfg_j.model).clone(dtype=jnp.float32)
    zeros_x = jnp.zeros((1, 28, 28, 1)), jnp.zeros((1, Z))
    params = _filled(jax.eval_shape(fmodel.init, jax.random.PRNGKey(0),
                                    *zeros_x)["params"], 0)
    fd = FlaxD(tuple(cfg_j.adversarial.d_widths))
    d_params = _filled(jax.eval_shape(fd.init, jax.random.PRNGKey(1),
                                      zeros_x[1])["params"], 1)
    flow = init_flow(jax.random.PRNGKey(2), Z, n_layers=2, hidden=8)
    for i, layer in enumerate(flow["layers"]):      # off the identity
        k1, k2 = jax.random.split(jax.random.PRNGKey(20 + i))
        layer["w3"] = 0.3 * jax.random.normal(k1, layer["w3"].shape)
        layer["b3"] = 0.3 * jax.random.normal(k2, layer["b3"].shape)
    x = (np.random.default_rng(0).random((B, 28, 28, 1)) < 0.4).astype(
        np.float32)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    case = {"cfg": json.loads(cfg_j.to_json()),
            "model": params_from_flax(np_tree(params)),
            "d": d_params_from_flax(np_tree(d_params)),
            "flow": flow_from_flax(np_tree(flow)), "x": torch.from_numpy(x),
            "eps": {}}
    # JAX's chunk noise: data shard i folds i into the key (n_data > 1),
    # k-shard j's chunk c draws from fold_in(key, j·n_local + c)
    key = jax.random.PRNGKey(SEED)
    for n_data, n_k in {g for _, g in JAX_CASES}:
        n_local, per = K // n_k // CHUNK, B // n_data
        case["eps"][(n_data, n_k)] = [[torch.stack([torch.tensor(
            np.asarray(jax.random.normal(jax.random.fold_in(
                jax.random.fold_in(key, i) if n_data > 1 else key,
                j * n_local + c), (CHUNK, per, Z), jnp.float32)))
            for c in range(n_local)]) for j in range(n_k)]
            for i in range(n_data)]
    torch.save(case, tmp / "case.pt")
    # the ranks, and the 4-rank dry run, run beside JAX's side below
    ranks = _Background(spawn, 4, "test_torch_sharded_iwae:_rank_sharded",
                        str(tmp), device="cpu", paths=(TESTS,))
    dry = _Background(dryrun_multiproc, 4, device="cpu")

    def d_apply(dp, z):
        return fd.apply({"params": dp}, z)

    def jax_case(prior, n_data, n_k):
        mesh = make_mesh_2d(n_data, n_k, jax.devices()[:n_data * n_k])
        xs = jax.device_put(x, NamedSharding(mesh, P("data")))
        kw = ({"d_apply": d_apply} if prior == "adversarial" else
              {"prior_logpdf": jexpost(flow)}
              if prior == "expost_flow" else {})
        f = jsharded(fmodel, "bernoulli", k=K, chunk=CHUNK, mesh=mesh, **kw)
        return np.asarray(jax.jit(f)(
            params, d_params, xs, xs, key,
            jnp.float32(LOG_Z if prior == "adversarial" else 0.0)))

    # one XLA program a case: compiled side by side (the backend pin is
    # global, so it holds in the pool's threads)
    with jdispatch.backend("jnp"), ThreadPoolExecutor(len(JAX_CASES)) as pool:
        futs = {f"jax_{prior}_{n_data}x{n_k}": pool.submit(
            jax_case, prior, n_data, n_k)
            for prior, (n_data, n_k) in JAX_CASES}
        want = {name: f.result() for name, f in futs.items()}
    assert len(ranks.result()) == 4
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(4)]
    cfg, model, d, flow_t = _port_parts(case)
    with torch.inference_mode():
        unsharded = make_iwae_fn(model, "bernoulli", K, CHUNK)(
            case["x"], case["x"], generator=torch.Generator().manual_seed(
                SEED)).numpy()
    return {"got": got, "want": want, "unsharded": unsharded, "cfg": cfg,
            "model": model, "dryrun": dry}


def _rows(got: list, name: str, n_data: int, n_k: int) -> np.ndarray:
    """The batch's scores in row order: the first rank of each data row."""
    return np.concatenate([got[d * n_k][name].numpy()
                           for d in range(n_data)])


@pytest.mark.parametrize("n_k", [2, 4])
def test_k_sharded_equals_unsharded_with_the_same_generator(runs, n_k):
    """k-shard i skips the chunk keys before its own, so the merged
    estimate is the unsharded one up to the merge's reassociation; every
    rank of the row holds it."""
    got = runs["got"]
    name = f"same_gen_1x{n_k}"
    np.testing.assert_allclose(got[0][name].numpy(), runs["unsharded"],
                               rtol=1e-5, atol=1e-4)
    for r in range(1, n_k):
        assert torch.equal(got[r][name], got[0][name])


@pytest.mark.parametrize("prior,grid", JAX_CASES,
                         ids=[f"{p}-{g[0]}x{g[1]}" for p, g in JAX_CASES])
def test_k_sharded_matches_jax_with_its_noise(runs, prior, grid):
    """JAX's chunk noise injected: the port's per-row scores against
    make_sharded_iwae_fn's on the same (data, k) mesh of virtual CPU
    devices, at the reference's bar."""
    name = f"jax_{prior}_{grid[0]}x{grid[1]}"
    np.testing.assert_allclose(_rows(runs["got"], name, *grid),
                               runs["want"][name], rtol=1e-5, atol=1e-4)


def test_data_shards_draw_independent_noise(runs):
    """The same rows on both data shards of a (2, 2) grid must not score
    alike: the data index is folded into the batch seed."""
    s = _rows(runs["got"], "dup_2x2", 2, 2)
    assert np.all(np.isfinite(s))
    assert not np.allclose(s[:4], s[4:])


def test_evaluate_nll_k_shards_equals_one_process(runs):
    """eval.k_shards=4 on four ranks: one data shard, the k=40 samples in
    four shards of one chunk, the scores gathered on every rank: the
    one-process evaluate_nll's, at the reference's bar."""
    from apv_tpu_torch.eval.run import eval_arrays, evaluate_nll
    cfg = runs["cfg"]
    want = evaluate_nll(cfg, runs["model"], None,
                        eval_arrays(cfg)["image"], k=40, chunk=10,
                        per_sample=True, seed=SEED,
                        device="cpu")["per_sample"]
    for r in range(4):
        np.testing.assert_allclose(runs["got"][r]["evaluate"], want,
                                   rtol=1e-5, atol=1e-4)
        assert np.array_equal(runs["got"][r]["evaluate"],
                              runs["got"][0]["evaluate"])


def test_k_shards_must_divide_the_ranks(runs):
    for r in range(4):
        assert "does not divide the 4 ranks" in runs["got"][r]["refused"]


def test_posterior_activity_gathers_the_one_process_result(runs):
    from apv_tpu_torch.eval.run import eval_arrays, posterior_activity
    cfg = runs["cfg"]
    want = posterior_activity(cfg, runs["model"], eval_arrays(cfg)["image"],
                              device="cpu")
    for r in range(4):
        got = runs["got"][r]["activity"]
        assert got["active_units"] == want["active_units"]
        np.testing.assert_allclose(got["max_unit_variance"],
                                   want["max_unit_variance"], rtol=1e-5)


def test_bad_shard_arithmetic_is_refused():
    grid = RankGrid(1, 4, 0, 0, None)
    with pytest.raises(ValueError, match="divide into n_k=4"):
        make_sharded_iwae_fn(None, "bernoulli", k=10, chunk=2, grid=grid)
    with pytest.raises(ValueError, match="need 16 ranks, have 1"):
        make_grid_2d(4, 4)


def test_eval_split_too_small_is_refused():
    assert _eval_batch_size(16, 32, 4) == 16
    assert _eval_batch_size(10, 32, 4) == 8
    with pytest.raises(ValueError, match="only 3 rows"):
        _eval_batch_size(8, 3, 4)


def test_dryrun_multiproc_four_ranks(runs):
    """The dry run over 4 ranks: every train path, then the k-sharded
    IWAE on a (2, 2) grid (data shards and k-shards both)."""
    out = runs["dryrun"].result()
    assert "trained flow prior step ok over 4 ranks" in out, out
    assert "k-sharded flow-prior IWAE over (2, 2) ok" in out, out
