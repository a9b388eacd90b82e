"""The plain reference against the program's own plain path, in float32 on
the CPU at small sizes, and the control against the reference."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import CELLS, TINY, TINY_WORK

from benchmark import run as harness
from benchmark.harness import check, manifest, seeded
from benchmark.reference import iwae, likelihood, models, stream
from benchmark.reference import train as ref_train


def tiny_tree(cell: str) -> dict:
    return harness._merge(manifest.cell(cell)["config"]["config"], TINY)


def program_config(tree: dict):
    from apv_tpu_torch.utils.config import config_from_dict
    return config_from_dict(tree)


def weights_for(tree: dict, seed: int = 3):
    with torch.device("meta"):
        vae, d = models.build_vae(tree["model"]), models.build_latent_d(tree)
    return (seeded.weights(vae, seed, "vae", "cpu"),
            seeded.weights(d, seed, "d", "cpu"))


@pytest.mark.parametrize("total,seed,offset", [(13, 5, 0), (64, 2 ** 62, 7),
                                               (1000, 123, 2 ** 40 + 3)])
def test_philox_stream_is_the_programs(total, seed, offset):
    from apv_tpu_torch.ops import kernels as K
    assert torch.equal(stream.normals(total, seed, offset, "cpu"),
                       K.philox_normals(total, seed, offset, "cpu"))


def test_step_generators_are_the_programs():
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.training.step import step_generator
    a, b = stream.step_generator(2 ** 33 + 1, 4), step_generator(2 ** 33 + 1,
                                                                 4)
    assert stream.draw_key(a) == K.draw_key(b)
    u = torch.rand(5, generator=stream.device_generator(a, "cpu"))
    v = torch.rand(5, generator=torch.Generator().manual_seed(
        int(torch.randint(0, 2 ** 63 - 1, (1,), generator=b))))
    assert torch.equal(u, v)


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[2]])
def test_reference_networks_are_the_programs_in_float32(cell):
    from apv_tpu_torch.models import build_model, make_latent_d
    tree = tiny_tree(cell)
    cfg = program_config(tree)
    w_vae, w_d = weights_for(tree)
    prog = build_model(cfg.model, dtype=torch.float32, device="cpu")
    prog.load_state_dict(w_vae)
    ref = models.build_vae(tree["model"])
    ref.load_state_dict(w_vae)
    h, w, c = tree["model"]["image_shape"]
    x = torch.rand(3, h, w, c) * 2 - 1
    z = torch.randn(3, tree["model"]["z_dim"])
    with torch.no_grad():
        for a, b in zip(prog.encode(x), ref.encode(x)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(prog.decode(z), ref.decode(z), rtol=1e-5,
                                   atol=1e-5)
        d_prog = make_latent_d(cfg.adversarial, cfg.model.z_dim,
                               device="cpu")
        d_prog.load_state_dict(w_d)
        d_ref = models.build_latent_d(tree)
        d_ref.load_state_dict(w_d)
        torch.testing.assert_close(d_prog(z), d_ref(z))


def test_likelihoods_are_the_programs():
    from apv_tpu_torch.ops import kernels as K
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (4, 3, 3, 3), generator=g) / 255.0
    out = torch.randn(4, 3, 3, 6, generator=g)
    want = K.disc_logistic_plain(x.reshape(4, -1),
                                 out[..., :3].reshape(4, -1),
                                 torch.clamp_min(out[..., 3:], -7.0)
                                 .reshape(4, -1))
    torch.testing.assert_close(likelihood.disc_logistic_ll(x, out), want)
    xb = (torch.rand(4, 3, 3, 1, generator=g) < 0.3).float()
    lb = torch.randn(4, 3, 3, 1, generator=g)
    torch.testing.assert_close(likelihood.bernoulli_ll(xb, lb),
                               K.bernoulli_plain(xb.reshape(4, -1),
                                                 lb.reshape(4, -1)))


CHECK_FROM = manifest.cell(CELLS[0])["workload"]["params"]["check_from_step"]


@pytest.mark.parametrize("start,atol", [(0, 1e-7), (CHECK_FROM, 5e-5)])
def test_reference_train_steps_are_the_programs_in_float32(start, atol):
    """Three of the program's float32 train steps on the CPU, from the same
    weights, rows and noise, against ``reference.follow``: the losses, KL,
    D(z) and parameters, and the rows as the program's resumed batcher cuts
    them. From step 0 (β 0, the learning rate at its warm-up's start) and
    from the step the train cell checks from (β 1, the learning rate past
    its warm-up, the optimizers' counts at that step). There Adam's first
    update from zero moments is ~3.2·lr = 1.6e-3 an element whatever the
    gradient's size, so a gradient of rounding's size moves its element by
    a rounding-sized share of that: 5e-5 holds those and refuses any wrong
    move."""
    from apv_tpu_torch.data.pipeline import Batcher
    from apv_tpu_torch.training.step import make_train_fns
    tree = tiny_tree(CELLS[0])
    tree["train"]["seed"] = seed = 2 ** 31 + 9
    cfg = program_config(tree)
    w_vae, w_d = weights_for(tree, seed)
    images = seeded.images(64, tuple(tree["model"]["image_shape"]), seed,
                           "t", "cpu")
    fns = make_train_fns(cfg, device="cpu", dtype=torch.float32)
    state = fns.init_fn(seed)
    state.model.load_state_dict(w_vae)
    state.d.load_state_dict(w_d)
    state.step = state.opt.count = state.d_opt.count = start
    batches = Batcher({"i": np.arange(64)}, cfg.train.batch_size,
                      seed=seed).iter_from(start)
    got = {"loss": [], "d_loss": [], "kl": [], "g_adv": []}
    for step in range(start, start + 3):
        rows = ref_train.batch_rows(64, cfg.train.batch_size, seed, step)
        np.testing.assert_array_equal(next(batches)["i"], rows)
        state, m = fns.train_step(state, {"image": images[torch.from_numpy(
            rows)]})
        for key in got:
            got[key].append(float(m[key]))
    ref = ref_train.follow(tree, w_vae, w_d, images, 3, seed, start=start)
    for key in got:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5,
                                   atol=1e-6)
    for group, module in (("vae", state.model), ("d", state.d)):
        for name, p in module.named_parameters():
            torch.testing.assert_close(p.detach(),
                                       ref["params"][(group, name)],
                                       rtol=1e-4, atol=atol)


@pytest.mark.parametrize("cell", [CELLS[1], CELLS[2]])
def test_reference_scores_are_the_programs_in_float32(cell):
    from apv_tpu_torch.eval.run import evaluate_nll
    from apv_tpu_torch.models import build_model, make_latent_d
    tree = tiny_tree(cell)
    cfg = program_config(tree)
    w_vae, w_d = weights_for(tree)
    model = build_model(cfg.model, dtype=torch.float32, device="cpu")
    model.load_state_dict(w_vae)
    d = make_latent_d(cfg.adversarial, cfg.model.z_dim, device="cpu")
    d.load_state_dict(w_d)
    binary = tree["data"]["binarize"]
    images = seeded.images(24, tuple(tree["model"]["image_shape"]), 1, "x",
                           "cpu", binary_p=0.2 if binary else None)
    got = evaluate_nll(cfg, model, d, images.numpy(), seed=77,
                       per_sample=True, device="cpu")
    e = tree["eval"]
    ref_d = models.build_latent_d(tree)
    ref_d.load_state_dict(w_d)
    ref_vae = models.build_vae(tree["model"])
    ref_vae.load_state_dict(w_vae)
    log_z = iwae.log_partition(ref_d, tree["model"]["z_dim"], 77, "cpu")
    assert got["log_partition"] == pytest.approx(log_z, rel=1e-5, abs=1e-6)
    want = iwae.scores(ref_vae, ref_d, images, list(range(24)),
                       batch=e["batch_size"], k=e["iwae_k"],
                       chunk=e["iwae_chunk"], seed=77,
                       likelihood=tree["model"]["likelihood"],
                       binary=binary, log_z=log_z)
    np.testing.assert_allclose(got["per_sample"],
                               [want[r] for r in range(24)], rtol=2e-5)


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_well_above_the_program(cell):
    """At the tiny size, on the CPU: the control (the reference one
    precision step down) against the reference reads at least three
    times what the program's bfloat16 path does, on its worst number."""
    from benchmark.tools import readings
    ctx = readings.ctx_for(cell, 11, torch.device("cpu"))
    ctx.config_tree = harness._merge(ctx.config_tree, TINY)
    ctx.workload = harness._merge(ctx.workload,
                                  TINY_WORK[ctx.workload["kind"]])
    read = (readings.train_readings if ctx.workload["kind"] == "train_loop"
            else readings.iwae_readings)
    rows = {r["role"]: r for r in read(ctx, True)}
    prog, ctrl = rows["program"], rows["control"]
    ratios = [ctrl[k] / prog[k] for k in ctx.workload["limits"]
              if prog[k] > 0]
    assert max(ratios) >= 3.0, (prog, ctrl)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_at_the_cells_size(card, cell):
    """On the card at the cell's own size: the control, and for the
    training cell each fault planted in the reference, is not correct
    under the committed limits, on three seeds."""
    from benchmark.tools import readings
    limits = manifest.cell(cell)["workload"]["limits"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        ctx = readings.ctx_for(cell, seed, card)
        read = (readings.train_readings
                if ctx.workload["kind"] == "train_loop"
                else readings.iwae_readings)
        rows = {r["role"]: r for r in read(ctx, True)}
        for role in [r for r in rows if r == "control"
                     or r.startswith("fault_")]:
            got = {k: rows[role][k] for k in limits}
            assert not check.verdict(got, limits)[0], (seed, role, got)
        prog = {k: rows["program"][k] for k in limits}
        assert check.verdict(prog, limits)[0], (seed, prog)
