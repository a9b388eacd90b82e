"""The train step's captured form (``training/graph.py``) on the CPU.

A CUDA graph exists only on the card (``test_torch_graph_step_card.py``
holds replayed steps to eager ones there). Here: when the loop captures;
the step's host block (keys, β, learning rates, bias corrections) and
device draws against what the step's generator gives, in the step's
order; and ``StepRunner``'s bookkeeping with a stand-in graph, whose
capture executes nothing (the state is put back) and whose replay runs
the captured ``run`` again on the runner's static inputs: replayed steps
equal eager ones bit for bit, the host counts advance as the eager
step's do, and the recorder counts the captures and replayed steps,
which the benchmark's ``replayed_step_share.train`` reads.
"""

import collections
import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from apv_tpu_torch.ops import kernels as K
from apv_tpu_torch.parallel import multihost
from apv_tpu_torch.training import graph as G
from apv_tpu_torch.training import loop as tloop
from apv_tpu_torch.training import step as tstep
from apv_tpu_torch.training.vdvae import VDVAEStep
from apv_tpu_torch.utils import logging as L
from apv_tpu_torch.utils.config import apply_overrides, get_preset

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FLAT = ["model.z_dim=8", "model.widths=[8,16]", "model.blocks_per_stage=1",
        "model.dense=32", "adversarial.d_widths=[16,16]",
        "train.batch_size=8", "train.steps_per_call=2", "train.log_every=2",
        "train.eval_every=0", "train.checkpoint_every=8"]
VDVAE = ["model.widths=[16]", "model.z_dim=4",
         "model.enc_blocks=8x1,8d2,4x1,4d4,1x1",
         "model.dec_blocks=1x1,4m1,4x1,8m4,8x1", "model.image_shape=[8,8,3]",
         "model.mix_components=2", "train.batch_size=4",
         "train.steps_per_call=2", "train.log_every=2",
         "train.checkpoint_every=8", "train.ema_decay=0.9"]
# (preset, overrides): the flagship, config 2 (MNIST), the IWAE objective,
# D's phases before G's with two critic steps, the flow prior with its
# dispersion penalty, and VDVAE
CASES = {
    "flagship": ("cifar_advprior_resnet", FLAT),
    "mnist": ("mnist_advprior", FLAT),
    "iwae": ("cifar_advprior_resnet", FLAT + ["train.objective=iwae",
                                              "train.iwae_k=3"]),
    "critic_first": ("cifar_advprior_resnet", FLAT + [
        "adversarial.d_reuse_posterior=false", "adversarial.n_critic=2"]),
    "flow_penalty": ("cifar_advprior_resnet", FLAT + [
        "model.prior=flow", "adversarial.enabled=false",
        "train.flow_dispersion_penalty=1.0"]),
    "vdvae": ("vdvae_cifar10", VDVAE),
}
START = 10            # inside β's and the learning rates' warm-ups


def _cfg(case: str, tmp_path=None, *extra: str):
    preset, sets = CASES[case]
    where = [f"results_dir={tmp_path}"] if tmp_path is not None else []
    return apply_overrides(get_preset(preset), sets + where + list(extra))


def _batches(cfg, n: int, seed: int = 0) -> list[dict]:
    g = torch.Generator().manual_seed(seed)
    b = cfg.train.batch_size
    h, w, c = cfg.model.image_shape
    if cfg.data.binarize and cfg.data.bit_pack:
        shape, key = (b, -(-h * w * c // 8)), "image_packed"
    else:
        shape, key = (b, h, w, c), "image"
    return [{key: torch.randint(0, 256, shape, generator=g,
                                dtype=torch.uint8)} for _ in range(n)]


def _state(fns, cfg, start: int = START):
    st = fns.init_fn(cfg.train.seed)
    st.step = start
    for o in (st.opt, st.d_opt):
        if o is not None:
            o.load_state_dict({"count": start, "mu": o.mu, "nu": o.nu})
    return st


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _host(st) -> list:
    return [getattr(o, a) for o, a in G._host_counts(st)]


class FakeGraph:
    """A CUDA graph's stand-in: the capture runs the call, then puts the
    state back (a capture executes nothing); a replay runs the runner's
    ``run`` again on its static inputs, leaves the host counts and the
    kernel counters as they were (the runner advances them) and writes the
    metrics into the captured outputs."""

    def __init__(self, runner, state):
        self.runner, self.state = runner, state
        self.saved = [t.clone() for t in state.tensors()]
        self.replays = 0

    @contextlib.contextmanager
    def capturing(self):
        yield
        for t, s in zip(self.state.tensors(), self.saved):
            t.copy_(s)

    def replay(self):
        r, st = self.runner, self.state
        host, launched = _host(st), [dict(c) for c in K.COUNTERS]
        _, m = r.fns.run(st, r.batch, r.inputs)
        for (o, a), v in zip(G._host_counts(st), host):
            setattr(o, a, v)
        for c, b in zip(K.COUNTERS, launched):
            c.clear()
            c.update(b)
        for dt, t in r.flat.items():
            t.copy_(torch.cat([m[n].reshape(-1) for n, d, _ in r.layout
                               if d == dt]))
        self.replays += 1

    def reset(self):
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    """Every StepRunner capture gets a FakeGraph; the list of them."""
    made = []
    real = G.StepRunner._capture

    def capture(self, state, batch):
        fake = FakeGraph(self, state)
        made.append(fake)
        monkeypatch.setattr(G, "new_graph", lambda: (fake, fake.capturing()))
        real(self, state, batch)
    monkeypatch.setattr(G.StepRunner, "_capture", capture)
    return made


@pytest.fixture(autouse=True)
def _fresh_recorder():
    L.RECORDER.reset()
    yield
    L.RECORDER.reset()


# -- when the loop captures --------------------------------------------------

@pytest.mark.parametrize("where,want", [
    ("cpu", False), ("cuda", True), ("cuda+group", False),
    ("cuda+grad_accum", False)])
def test_capture_engages_only_where_it_can(monkeypatch, where, want):
    """A CUDA device with no process group and no gradient accumulation:
    the CPU, gloo's collectives and an accumulating optimizer's host
    micro-step keep every step eager."""
    cfg = _cfg("flagship", None, *(["train.grad_accum=2"]
                                   if "grad_accum" in where else []))
    monkeypatch.setattr(multihost, "active", lambda: "group" in where)
    assert G.capturable(cfg, torch.device(where.split("+")[0])) is want


def test_loop_on_the_cpu_runs_every_step_eagerly(tmp_path, monkeypatch):
    """The loop asks ``capturable``; on the CPU no step is captured."""
    made = []
    real = G.StepRunner.__init__

    def init(self, fns, capture):
        made.append(capture)
        real(self, fns, capture)
    monkeypatch.setattr(G.StepRunner, "__init__", init)
    cfg = _cfg("flagship", tmp_path)
    tloop.train_loop(cfg, max_steps=4, arrays={"image": np.zeros(
        (32, 32, 32, 3), np.uint8)}, device="cpu")
    (summary,) = L.summaries()
    assert made == [False]
    assert summary["captures"] == summary["replayed_steps"] == 0


# -- the family behind the step ----------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_each_preset_takes_its_familys_step(case, monkeypatch):
    """``make_train_fns`` picks the family's step at one place: VDVAE's for
    the vdvae preset, the encode -> z -> decode step for the others; a
    train step runs that family's ``step`` once and no other's."""
    ran = []
    for cls in (tstep.EncodeDecodeStep, VDVAEStep):
        def spy(self, *args, real=cls.step):
            ran.append(type(self))
            return real(self, *args)
        monkeypatch.setattr(cls, "step", spy)
    cfg = _cfg(case)
    fns = tstep.make_train_fns(cfg, device="cpu", dtype=torch.float32)
    fns.train_step(_state(fns, cfg), _batches(cfg, 1)[0])
    assert ran == [VDVAEStep if CASES[case][0] == "vdvae_cifar10"
                   else tstep.EncodeDecodeStep]


# -- the step's host block and device draws ----------------------------------

def _want_draws(cfg, state, batch) -> tuple[list, list, dict]:
    """(keys, numbers, device draws' seeds) of the step, re-derived from
    its generator in the order the module docstring states."""
    gen = tstep.step_generator(state.seed, state.step)
    a = cfg.adversarial

    def seed():
        return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=gen))

    keys, seeds = [], collections.defaultdict(list)
    if cfg.model.family == "vdvae":
        keys = [K.draw_key(gen) for _ in
                cfg.model.dec_blocks.split(",")]
        return keys, [state.opt.lr(state.opt.count)], seeds
    if cfg.data.dequantize and "image" in batch:
        seeds["u"].append(seed())
    if a.enabled and not a.d_reuse_posterior:
        for _ in range(a.n_critic):
            keys.append(K.draw_key(gen))
            seeds["z_p"].append(seed())
    keys.append(K.draw_key(gen))
    if cfg.model.prior == "flow" and cfg.train.flow_dispersion_penalty > 0:
        seeds["u_disp"].append(seed())
    if a.enabled and a.d_reuse_posterior:
        seeds["z_p"] += [seed() for _ in range(a.n_critic)]
    t = state.opt.count + 1
    numbers = [tstep._beta(cfg, state.step), state.opt.lr(state.opt.count),
               1 - state.opt.b1 ** t, 1 - state.opt.b2 ** t]
    if a.enabled:
        d = state.d_opt
        for i in range(a.n_critic):
            numbers += [d.lr(d.count + i), 1 - d.b1 ** (d.count + i + 1),
                        1 - d.b2 ** (d.count + i + 1)]
    return keys, numbers, seeds


@pytest.mark.parametrize("case", ["flagship", "critic_first",
                                  "flow_penalty", "vdvae"])
def test_block_holds_the_steps_draws_in_order(case):
    """``draw``'s keys and numbers (β, each optimizer call's learning rate
    and bias corrections, float32) and its device draws are what the
    step's generator gives in the step's order, at a step inside the
    warm-ups; written in place into an earlier draw's inputs they are the
    same bits."""
    cfg = _cfg(case)
    fns = tstep.make_train_fns(cfg, device="cpu", dtype=torch.float32)
    state = _state(fns, cfg)
    batch = _batches(cfg, 1)[0]
    got = fns.draw(state, batch)
    keys, numbers, seeds = _want_draws(cfg, state, batch)
    assert got["keys"].tolist() == [list(k) for k in keys]
    assert _bits(got["hyper"]).equal(
        _bits(torch.tensor(numbers, dtype=torch.float32)))
    b, z = cfg.train.batch_size, cfg.model.z_dim
    for name, drawn in seeds.items():
        rows = [torch.rand(batch["image"].shape,
                           generator=torch.Generator().manual_seed(s))
                if name == "u" else
                torch.randn((b, z), generator=torch.Generator().manual_seed(s))
                for s in drawn]
        want = rows[0] if name != "z_p" else torch.stack(rows)
        assert _bits(got[name]).equal(_bits(want)), name
    assert set(got) == {"block", "keys", "hyper", *seeds}
    later = tstep.make_train_fns(cfg, device="cpu", dtype=torch.float32)
    other = _state(later, cfg, START + 5)
    out = later.draw(other, batch)
    again = later.draw(state, batch, out=out)
    for name in got:
        assert _bits(out[name]).equal(_bits(got[name])), name
        assert again[name].data_ptr() == out[name].data_ptr(), name


def test_injected_noise_is_not_drawn():
    """Noise handed in is taken as it is: no key and no device draw for
    it (the parity tests hand in JAX's draws)."""
    cfg = _cfg("flagship")
    fns = tstep.make_train_fns(cfg, device="cpu", dtype=torch.float32)
    state = _state(fns, cfg)
    batch = _batches(cfg, 1)[0]
    b, z = cfg.train.batch_size, cfg.model.z_dim
    noise = {"u": torch.full(batch["image"].shape, 0.5),
             "eps": torch.zeros(b, z), "z_p": torch.ones(1, b, z)}
    got = fns.draw(state, batch, noise=noise)
    assert got["keys"].shape == (0, 2)
    assert all(got[k] is v for k, v in noise.items())


# -- the runner: replayed steps against eager ones ---------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_steps_equal_eager_steps(case, fake_graphs):
    """Five steps from one state at step 10: eagerly, and through a
    capturing ``StepRunner`` (the first eager, the second captured, every
    one after replayed): the states (every tensor), the host counts and
    each step's metrics are the same bits, and the runner counted one
    capture and four replays."""
    cfg = _cfg(case)
    fns = tstep.make_train_fns(cfg, device="cpu", dtype=torch.float32)
    batches = _batches(cfg, 5)
    runs = []
    for capture in (False, True):
        st = _state(fns, cfg)
        runner = G.StepRunner(fns, capture)
        ms = []
        for b in batches:
            st, m = runner(st, b)
            ms.append({n: v.clone() for n, v in m.items()})
        runner.close()
        runs.append((st, ms))
    (sa, ma), (sb, mb) = runs
    assert _host(sa) == _host(sb)
    assert sa.step == START + 5
    for x, y in zip(sa.tensors(), sb.tensors()):
        assert _bits(x).equal(_bits(y))
    for x, y in zip(ma, mb):
        assert set(x) == set(y)
        for n in x:
            assert x[n].dtype == y[n].dtype and _bits(x[n]).equal(
                _bits(y[n])), n
    (fake,) = fake_graphs
    assert fake.replays == 4
    assert L.RECORDER.graph == {"captures": 1, "replayed_steps": 4}


def test_a_replayed_step_refuses_another_batch_shape(fake_graphs):
    cfg = _cfg("flagship")
    fns = tstep.make_train_fns(cfg, device="cpu", dtype=torch.float32)
    st, runner = _state(fns, cfg), G.StepRunner(fns, True)
    b = _batches(cfg, 2)
    for x in b:
        st, _ = runner(st, x)
    with pytest.raises(ValueError, match="captured at"):
        runner(st, {"image": b[0]["image"][:4]})


def test_loop_counts_captures_and_replays(tmp_path, monkeypatch,
                                         fake_graphs):
    """A capturing ``train_loop`` (the stand-in graph) ends in the state
    of an eager one, bit for bit; its summary and each record interval
    count the capture and the replayed steps, and the benchmark's reader
    takes the window's share from them."""
    images = np.random.default_rng(0).integers(0, 256, (48, 32, 32, 3),
                                               dtype=np.uint8)
    states = []
    for capture in (False, True):
        monkeypatch.setattr(tloop, "capturable", lambda cfg, dev, c=capture:
                            c)
        states.append(tloop.train_loop(
            _cfg("flagship", tmp_path / str(capture)), max_steps=8,
            arrays={"image": images}, device="cpu"))
    for x, y in zip(states[0].tensors(), states[1].tensors()):
        assert _bits(x).equal(_bits(y))
    eager, captured = L.summaries()
    assert (eager["captures"], eager["replayed_steps"]) == (0, 0)
    assert (captured["captures"], captured["replayed_steps"]) == (1, 7)
    assert [(iv["steps"], iv["replayed_steps"])
            for iv in captured["intervals"]] == [(2, 2)] * 3
    assert all(iv["replayed_steps"] == iv["captures"] == 0
               for iv in eager["intervals"])


def _summary(profiled, intervals):
    return {"kind": "train_loop", "profiled": profiled,
            "intervals": intervals, "spans": {}, "syncs": 0,
            "unit_leads_ms": {}}


@pytest.mark.parametrize("counts,want", [
    (None, None), ([(1, 0), (4, 4), (4, 3)], 87.5),
    ([(1, 1), (8, 8)], 100.0)])
def test_replayed_step_share_reader(monkeypatch, counts, want):
    """The window's replayed steps over its steps, in percent, its first
    interval (the loop's start) left out; None for a program whose
    intervals carry no counts, and outside a train cell."""
    from benchmark.harness import manifest
    from benchmark.harness.stretch import Stretch
    read = manifest.reader("replayed_step_share.train")

    def interval(steps, replayed):
        iv = {"steps": steps, "step_ms": 1.0, "sync_wait_ms": 0.0,
              "leads_ms": [], "syncs": 0, "self_ms": {}}
        if counts is not None:
            iv.update(captures=0, replayed_steps=replayed)
        return iv

    rows = counts or [(1, 0), (4, 4)]
    monkeypatch.setattr(L.RECORDER, "summaries", collections.deque([
        _summary(False, [interval(*r) for r in rows]),
        _summary(True, [interval(2, 2)])]))
    got = read(Stretch(unit="train", events=[]))
    assert got == (None if want is None else pytest.approx(want))
    assert read(Stretch(unit="iwae", events=[])) is None
