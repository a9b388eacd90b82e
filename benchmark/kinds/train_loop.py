"""Traffic kind ``train_loop``: the program's training loop on a train set
resident on the card, as users run it.

Set-up, in one process:

1. the train set (uint8, the dataset's shape, ``params.train_images``
   images) and the weights of the VAE and of the latent D are made from
   the seed on the card; the weights enter the program as the checkpoint
   of step ``params.check_from_step`` (both optimizers' moments zero,
   their counts at that step) that the loop resumes from: a step at which
   β and the learning rate have left their warm-ups, so that the KL and
   D(z) weigh in G's gradient in full;
2. the loop's ``CHECK_STEPS`` steps from there, one step a call, each
   logged and checkpointed: what the reference follows
   (``reference/train.py``);
3. three calls of ``steps_per_call`` steps, one record a call: the warm-up,
   whose last call sizes the window.

The window is one more ``train_loop`` call, resumed, at the
configuration's own settings. Its rate is timed from the first to the last
of the loop's read-back points (its records at ``log_every``; the host
clock of ``harness/tap.py``), counting the steps that had finished at each;
the loop's start before the first and its closing save after the last go
to ``setup_s``. With ``--trace 1`` the window is the unprofiled stretch,
and the profiled one is the loop's own profiler window (steps 10-15 of a
call: at the preset's 8 steps a call, one call) in one more, short
``train_loop`` call after it, which runs one call past the window so that
its closing save stays out: a profiler that has run slows the host for
the rest of the process, so it never runs before the timed span.

``correct``: after the window, the reference follows the same
``CHECK_STEPS`` steps from the same weights, batches and noise; compared
are the first step's gradients as the optimizers take them, read from
their first moments after one step (``grad_gap``), and the parameters'
change after the steps (``change_gap``), each by the worst leaf of the
VAE and of D against the larger of its reference norm and its group's
median (``harness/check``); and the worst gaps of the steps' batch means
of the KL (``kl_gap``, relative) and of D(z) (``adv_gap``, in the
reference batch's standard deviations of D(z), since its mean may lie
near 0), as G computes them before β scales them, and of D's loss
(``d_loss_gap``, relative). The change leaves out the leaves whose
reference gradient is under a thousandth of the median leaf's. The worst
relative gap of the steps' G losses (``loss_gap``) is printed beside
them.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import re
import time
from pathlib import Path

import torch

from benchmark.harness import check, counts, seeded, tap
from benchmark.harness import trace as T
from benchmark.harness.stretch import Stretch
from benchmark.reference import models
from benchmark.reference import train as reference

CHECK_STEPS = 3
G_B1, D_B1 = 0.9, 0.5           # the optimizers' first-moment decays
# G's loss gap has no upper reading: the control and the planted faults
# read within a few times what sound runs do (PERF.md), so a limit on it
# could only fail sound runs. It is printed, not compared.
NOT_COMPARED = ("loss_gap",)


def _config(ctx, **train):
    from apv_tpu_torch.utils.config import config_from_dict
    tree = copy.deepcopy(ctx.config_tree)
    tree["results_dir"] = str(ctx.workdir)
    tree["train"].update(train)
    return config_from_dict(tree)


def step_kernels(tree: dict) -> dict:
    """The port kernels of one train step at the configuration's shapes:
    name -> (launches, shapes for ``counts.kernel_work``)."""
    t, m = tree["train"], tree["model"]
    b, z = t["batch_size"], m["z_dim"]
    h, w, c = m["image_shape"]
    post = dict(samples=1, n=b * z, rows=b, kl=True)
    if m["likelihood"] != "discretized_logistic":
        raise ValueError("train_loop reckons the disc-logistic step only")
    like = dict(rows=b, event=h * w * c, x_rows=b)
    return {"reparam": (1, post), "reparam_bwd": (1, post),
            "disc_logistic": (1, like), "disc_logistic_bwd": (1, like)}


def profiled_calls(k: int, first: int = 10, last: int = 15
                   ) -> tuple[int, int]:
    """(start, stop): the steps, counted from a call's start, at which the
    loop's profiler window (its steps ``first``-``last``) starts and stops
    when each of its calls runs ``k`` steps: it starts before the call that
    holds ``first`` and stops before the first call after it that reaches
    past ``last`` (``MetricLogger.maybe_trace``)."""
    base, start = 0, None
    while True:
        if start is None and base <= first < base + k:
            start = base
        elif start is not None and base + k > last:
            return start, base
        base += k


def _steps_of(ckpt_dir: Path) -> dict[int, Path]:
    out = {}
    for p in ckpt_dir.iterdir():
        m = re.fullmatch(r"step_(\d+)\.pt", p.name)
        if m:
            out[int(m.group(1))] = p
    return out


def _named(saved_params: dict, moments: list, b1: float, group: str):
    names = list(saved_params)
    if len(names) != len(moments) or any(
            saved_params[n].shape != mu.shape for n, mu in zip(names,
                                                               moments)):
        raise ValueError(f"the {group} optimizer's moments do not line up "
                         "with its parameters")
    return {(group, n): float(torch.linalg.vector_norm(mu.double()))
            / (1.0 - b1) for n, mu in zip(names, moments)}


def program_readings(run_dir: Path, start: int, w_vae: dict,
                     w_d: dict) -> dict:
    """The program's losses, KL and D(z) of the checked steps from step
    ``start`` (its metrics file), its first gradients (its optimizers'
    first moments after one step) and its parameters' change after
    ``CHECK_STEPS`` steps."""
    recs = [json.loads(x) for x in
            (run_dir / "metrics.jsonl").read_text().splitlines() if x]
    by_step = {r["step"]: r for r in recs if "loss" in r}
    steps = _steps_of(run_dir / "checkpoints")
    one = torch.load(steps[start + 1], map_location="cpu",
                     weights_only=True)
    last = torch.load(steps[start + CHECK_STEPS], map_location="cpu",
                      weights_only=True)
    grad = {**_named(one["model"], one["opt"]["mu"], G_B1, "vae"),
            **_named(one["d"], one["d_opt"]["mu"], D_B1, "d")}
    change = {}
    for group, saved, w in (("vae", last["model"], w_vae),
                            ("d", last["d"], w_d)):
        for n, p in saved.items():
            change[(group, n)] = float(torch.linalg.vector_norm(
                p.double() - w[n].cpu().double()))
    checked = [by_step[s] for s in range(start, start + CHECK_STEPS)]
    return {**{key: [r[key] for r in checked]
               for key in ("loss", "d_loss", "kl", "g_adv")},
            "grad": grad, "change": change}


def readings_of(follow_out: dict, w_vae: dict, w_d: dict) -> dict:
    """A reference run's readings in the program's form (for the control
    and planted faults, put in the program's place)."""
    w0 = {**{("vae", n): t for n, t in w_vae.items()},
          **{("d", n): t for n, t in w_d.items()}}
    return {**{key: follow_out[key]
               for key in ("loss", "d_loss", "kl", "g_adv", "g_adv_scale")},
            "grad": follow_out["grad"],
            "change": {k: float(torch.linalg.vector_norm(
                (p - w0[k]).double())) for k, p in
                follow_out["params"].items()}}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of ``correct``: program (or stand-in) readings against
    the reference's (both in ``readings_of``'s form)."""
    def rel(key, scale=None):
        pairs = list(zip(prog[key], ref[key]))
        if not all(math.isfinite(a) for a, _ in pairs):
            return math.inf
        scale = scale or [abs(b) for _, b in pairs]
        return max(abs(a - b) / max(s, 1e-30)
                   for (a, b), s in zip(pairs, scale))
    grad_gap, grad_leaf = check.leaf_gaps(prog["grad"], ref["grad"])
    change_gap, change_leaf = check.leaf_gaps(
        prog["change"], ref["change"], exclude=check.negligible(ref["grad"]))
    return {"numbers": {"loss_gap": rel("loss"), "d_loss_gap": rel("d_loss"),
                        "grad_gap": grad_gap, "change_gap": change_gap,
                        "kl_gap": rel("kl"),
                        "adv_gap": rel("g_adv", ref["g_adv_scale"])},
            "worst": {"grad_gap": grad_leaf, "change_gap": change_leaf}}


class Prepared:
    """A run's set-up up to the checked steps: the train set and the
    weights from the seed, the checkpoint of step ``start`` that hands the
    weights to the program, and the loop's ``CHECK_STEPS`` steps from
    there."""

    def __init__(self, ctx):
        from apv_tpu_torch.training.step import make_train_fns
        from apv_tpu_torch.utils.checkpoint import save_checkpoint

        tree, p, dev = ctx.config_tree, ctx.workload["params"], ctx.device
        self.ctx, self.tree = ctx, tree
        self.start = p["check_from_step"]
        self.images = seeded.images(p["train_images"],
                                    tuple(tree["model"]["image_shape"]),
                                    ctx.seed, "train_images", dev)
        self.arrays = {"image": self.images.cpu().numpy()}
        with torch.device("meta"):
            vae_meta = models.build_vae(tree["model"])
            d_meta = models.build_latent_d(tree)
        self.w_vae = seeded.weights(vae_meta, ctx.seed, "vae", dev)
        self.w_d = seeded.weights(d_meta, ctx.seed, "d", dev)
        cfg = _config(ctx)
        self.run_dir = Path(cfg.results_dir) / cfg.name
        state = make_train_fns(cfg, device=dev).init_fn(cfg.train.seed)
        state.model.load_state_dict(self.w_vae)
        state.d.load_state_dict(self.w_d)
        state.step = state.opt.count = self.start
        if state.d_opt is not None:
            state.d_opt.count = self.start
        save_checkpoint(self.run_dir / "checkpoints", state, self.start)

    def checked_steps(self) -> dict:
        """The loop's checked steps, one a call, each logged and saved;
        the program's readings of them."""
        from apv_tpu_torch.training.loop import train_loop
        with tap.RecordTap():
            train_loop(_config(self.ctx, steps_per_call=1, log_every=1,
                               checkpoint_every=1), max_steps=CHECK_STEPS,
                       arrays=self.arrays, resume=True,
                       device=self.ctx.device)
        return program_readings(self.run_dir, self.start, self.w_vae,
                                self.w_d)

    def reference(self, prec=None, rows=None, fault=None) -> dict:
        """The reference's readings of the same steps (with ``rows`` or
        ``fault``, a planted fault's: ``reference.follow``)."""
        return readings_of(reference.follow(
            self.tree, self.w_vae, self.w_d, self.images, CHECK_STEPS,
            self.ctx.seed, prec, rows, self.start, fault), self.w_vae,
            self.w_d)


def run(ctx) -> dict:
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.training.loop import train_loop

    tree, dev = ctx.config_tree, ctx.device
    t = tree["train"]
    b, k, log_every = t["batch_size"], t["steps_per_call"], t["log_every"]
    phases = {"imported": time.perf_counter() - ctx.t0}
    prep = Prepared(ctx)
    phases["inputs_and_step0"] = time.perf_counter() - ctx.t0
    first = prep.checked_steps()
    phases["checked_steps"] = time.perf_counter() - ctx.t0

    with tap.RecordTap() as warm:
        train_loop(_config(ctx, log_every=k), max_steps=3 * k,
                   arrays=prep.arrays, resume=True, device=dev)
    (ta, _), (tb, _) = warm.records[-2:]
    t_step = (tb - ta) / k
    phases["warm_up"] = time.perf_counter() - ctx.t0

    s0 = prep.start + CHECK_STEPS + 3 * k
    r1 = -(-s0 // log_every) * log_every      # the window's first record
    n_int = max(1, round(ctx.seconds / (log_every * t_step)))
    n_steps = -(-(r1 + n_int * log_every - s0 + 1) // k) * k
    before = dict(K.launches)
    steal0 = tap.host_steal()
    with tap.RecordTap() as win:
        train_loop(_config(ctx), max_steps=n_steps, arrays=prep.arrays,
                   resume=True, device=dev)
    t_return = time.perf_counter()
    steal1 = tap.host_steal()
    counted = {n: K.launches[n] - before[n] for n in K.launches}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    def done_at(step: int) -> int:       # steps finished at its read-back
        return s0 + ((step - s0) // k + 1) * k

    recs = [(tt, s) for tt, s in win.records if s % log_every == 0]
    (t_first, s_first), (t_last, s_last) = recs[0], recs[-1]
    phases["first_record"] = t_first - ctx.t0
    steps_timed = done_at(s_last) - done_at(s_first)
    span = t_last - t_first
    window = [json.loads(x) for x in (prep.run_dir / "metrics.jsonl")
              .read_text().splitlines()[-len(recs):]]
    failed = sum(1 for r in window if not math.isfinite(r.get("loss",
                                                              math.nan)))
    out = {"measured": {"train_images_per_s": steps_timed * b / span,
                        "setup_s": (t_first - ctx.t0)
                        + (t_return - t_last)},
           "attempted": n_steps, "failed": failed,
           "memory_peak_bytes": peak,
           "notes": {"window_steps": n_steps, "timed_steps": steps_timed,
                     "timed_s": span, "warm_step_ms": 1e3 * t_step,
                     "closing_s": t_return - t_last,
                     "record_gaps_s": [b_[0] - a_[0] for a_, b_ in
                                       zip(recs, recs[1:])],
                     "setup_phases_s": phases,
                     "host_steal_share": None if steal0 is None else
                     (steal1[0] - steal0[0]) / max(1, steal1[1] - steal0[1])}}

    if ctx.trace:
        trace_dir = ctx.workdir / "trace"
        # one more call after the profiled ones keeps the closing save
        # out of the stretch
        start, stop = profiled_calls(k)
        with tap.RecordTap():
            train_loop(_config(ctx), max_steps=stop + k, arrays=prep.arrays,
                       resume=True, trace_dir=str(trace_dir), device=dev)
        (path,) = sorted(trace_dir.glob("*.json"))
        kernels, expect = {}, {}
        for name, (n, shapes) in step_kernels(tree).items():
            nbytes, ops = counts.kernel_work(name, **shapes)
            m = n * (stop - start)
            kernels[name] = {"launches": m, "bytes": m * nbytes,
                             "ops": m * ops}
            expect[name] = (counted.get(name), n * n_steps)
        out["stretch"] = Stretch(
            unit="train", events=T.load(path), steps=stop - start,
            kernels=kernels,
            counted=expect, card=ctx.card,
            flops_per_image=counts.train_flops_per_image(tree),
            timed_images=steps_timed * b, timed_seconds=span)

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with ctx.reference_precision():
        ref = prep.reference()
    cmp = compare(first, ref)
    out["numbers"] = {n: v for n, v in cmp["numbers"].items()
                      if n not in NOT_COMPARED}
    out["notes"]["not_compared"] = {n: cmp["numbers"][n]
                                    for n in NOT_COMPARED}
    out["notes"]["worst_leaf"] = {k_: str(v) for k_, v in
                                  cmp["worst"].items()}
    return out
