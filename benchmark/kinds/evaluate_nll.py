"""Traffic kind ``evaluate_nll``: IWAE-k scoring of a test set under the
learned adversarial prior, through the program's ``evaluate_nll`` at the
configuration's ``eval`` settings (k, chunk, batch).

Set-up: the test set (``params.test_images`` uint8 images of the
dataset's shape; binary pixels, 1 with probability ``params.binary_p``,
for a binarized configuration) and the weights of the VAE and the latent D
are made from the seed on the card and handed to the program's VAE and D.
The warm-up is two calls as the window makes them; the second sizes the
window.

The window: with ``params.call_batches`` null, one call over as many
batches as the warm-up's rate says fill ``--seconds`` (at most the test
set); otherwise calls of ``call_batches`` batches, each on the next images
of the test set (wrapping) with a seed of its own, as many as fill
``--seconds``. Every call estimates log Z first, as the program does. The
rate is the images scored over the wall from the first call's start to
the last call's return, which reads the scores back.

With ``--trace 1`` one more call, as the window makes them, is the
profiled stretch; the window is the unprofiled one.

``correct``: once the window has closed, ``params.check_images`` of the
images scored in it, drawn from the seed, are scored again by the
reference with the same weights and noise (``reference/iwae.py``), and
each call's log Z too, and once more by the reference computed in the
configuration's stated precision (bfloat16 products where it states
them). Compared are the worst gap of a score in units of the stated
precision's worst gap (``score_gap``) and the worst gap of a call's log
Z (``log_z_gap``); a score that is not finite, or an image left
unscored, fails.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark.harness import counts, seeded
from benchmark.harness import trace as T
from benchmark.harness.stretch import Stretch
from benchmark.reference import iwae as reference
from benchmark.reference import models
from benchmark.reference.models import Precision


def call_kernels(tree: dict, images: int) -> dict:
    """The port kernels of a call over ``images`` images: name ->
    (launches, shapes for ``counts.kernel_work``)."""
    m, e = tree["model"], tree["eval"]
    b, k, chunk, z = e["batch_size"], e["iwae_k"], e["iwae_chunk"], m["z_dim"]
    h, w, c = m["image_shape"]
    n = (images // b) * (k // chunk)
    like = {"discretized_logistic": "disc_logistic",
            "bernoulli": "bernoulli"}[m["likelihood"]]
    return {"reparam": (n, dict(samples=chunk, n=b * z, rows=b, kl=False)),
            like: (n, dict(rows=chunk * b, event=h * w * c, x_rows=b))}


def _calls(p: dict, n_test: int, batch: int, n_calls: int, seed: int):
    """(first image, images, seed) of each call of the window."""
    per = p["call_batches"] * batch
    starts = range(0, n_test - per + 1, per)
    return [(starts[j % len(starts)], per, seed + 1000 * j)
            for j in range(n_calls)]


class Prepared:
    """A run's set-up: the test set, the weights and the program's VAE
    and D holding them."""

    def __init__(self, ctx):
        from apv_tpu_torch.eval.run import evaluate_nll
        from apv_tpu_torch.models import build_model, make_latent_d
        from apv_tpu_torch.utils.config import config_from_dict

        tree, p, dev = ctx.config_tree, ctx.workload["params"], ctx.device
        m = tree["model"]
        self.tree, self.p = tree, p
        self.batch = tree["eval"]["batch_size"]
        binary = bool(tree["data"]["binarize"])
        self.test = seeded.images(p["test_images"], tuple(m["image_shape"]),
                                  ctx.seed, "test_images", dev,
                                  binary_p=p["binary_p"] if binary else None)
        self.test_np = self.test.cpu().numpy()
        with torch.device("meta"):
            vae_meta = models.build_vae(m)
            d_meta = models.build_latent_d(tree)
        self.w_vae = seeded.weights(vae_meta, ctx.seed, "vae", dev)
        self.w_d = seeded.weights(d_meta, ctx.seed, "d", dev)
        self.cfg = config_from_dict({**tree, "results_dir": str(ctx.workdir)})
        self.model = build_model(self.cfg.model, device=dev)
        self.model.load_state_dict(self.w_vae)
        self.d = make_latent_d(self.cfg.adversarial, self.cfg.model.z_dim,
                               device=dev)
        self.d.load_state_dict(self.w_d)
        self.seed0 = seeded.derive(ctx.seed, "eval") >> 2
        self.one = self.batch * (1 if p["call_batches"] is None
                                 else p["call_batches"])
        self._evaluate, self._dev = evaluate_nll, dev

    def call(self, first: int, count: int, seed: int) -> dict:
        """One call of the program's ``evaluate_nll``."""
        return self._evaluate(self.cfg, self.model, self.d,
                              self.test_np[first:first + count], seed=seed,
                              per_sample=True, device=self._dev)

    def release(self) -> None:
        del self.model, self.d
        gc.collect()
        if self._dev.type == "cuda":
            torch.cuda.empty_cache()


def run(ctx) -> dict:
    from apv_tpu_torch.ops import kernels as K

    dev, p = ctx.device, ctx.workload["params"]
    prep = Prepared(ctx)
    tree, batch = prep.tree, prep.batch
    # warm-up: two calls as the window makes them; the second, past the
    # first call's one-time costs, sizes the window
    prep.call(0, prep.one, prep.seed0)
    t0 = time.perf_counter()
    prep.call(0, prep.one, prep.seed0)
    t_warm = time.perf_counter() - t0
    n = max(1, round(ctx.seconds / t_warm))
    if p["call_batches"] is None:
        calls = [(0, min(n, p["test_images"] // batch) * batch, prep.seed0)]
    else:
        calls = _calls(p, p["test_images"], batch, n, prep.seed0)

    t_begin = time.perf_counter()
    results = [prep.call(*c) for c in calls]
    t_end = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    images = sum(c[1] for c in calls)
    scores = [r["per_sample"] for r in results]
    failed = sum(int(np.sum(~np.isfinite(s))) for s in scores) + sum(
        c[1] - len(s) for c, s in zip(calls, scores))
    out = {"measured": {"iwae_images_per_s": images / (t_end - t_begin),
                        "setup_s": t_begin - ctx.t0},
           "attempted": images, "failed": failed,
           "memory_peak_bytes": peak,
           "notes": {"calls": len(calls), "images": images,
                     "window_s": t_end - t_begin, "warm_call_s": t_warm}}

    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        before = dict(K.launches)
        with profile(activities=acts) as prof:
            prep.call(calls[0][0], prep.one, prep.seed0 + 7)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        path = ctx.workdir / "iwae_trace.json"
        prof.export_chrome_trace(str(path))
        events = T.load(path)
        path.unlink()
        got = {n_: K.launches[n_] - before[n_] for n_ in K.launches}
        kernels, expect = {}, {}
        for name, (n_, shapes) in call_kernels(tree, prep.one).items():
            nbytes, ops = counts.kernel_work(name, **shapes)
            kernels[name] = {"launches": n_, "bytes": n_ * nbytes,
                             "ops": n_ * ops}
            expect[name] = (got.get(name), n_)
        out["stretch"] = Stretch(
            unit="iwae", events=events, images=prep.one, kernels=kernels,
            counted=expect, card=ctx.card,
            flops_per_image=counts.iwae_flops_per_image(
                tree, tree["eval"]["iwae_k"]),
            timed_images=images, timed_seconds=t_end - t_begin)
        reparam = [ev.start for ev in T.device_events(events)
                   if "reparam_samples" in ev.name]
        if reparam:
            s, end = T.span_us(events)
            out["notes"]["log_z_share_of_call"] = (min(reparam) - s) / (
                end - s)

    prep.release()
    picks = pick_rows(ctx.seed, calls, p["check_images"])
    prog = program_scores(calls, results, picks)
    with ctx.reference_precision():
        ref = reference_scores(prep, calls, picks, Precision())
        stated = reference_scores(prep, calls, picks, Precision("stated"))
    out["numbers"] = gaps(prog, ref, stated)
    return out


def pick_rows(seed: int, calls: list, count: int) -> dict[int, list[int]]:
    """``count`` of the window's images, drawn from the seed: call ->
    rows."""
    flat = [(j, r) for j, c in enumerate(calls) for r in range(c[1])]
    rng = np.random.default_rng(seeded.derive(seed, "check"))
    by_call: dict[int, list[int]] = {}
    for i in sorted(rng.choice(len(flat), min(count, len(flat)),
                               replace=False).tolist()):
        j, r = flat[i]
        by_call.setdefault(j, []).append(r)
    return by_call


def program_scores(calls, results, picks) -> tuple[dict, dict]:
    """({(call, row): score}, {call: log Z}) of the program's results;
    a row past the scores reads NaN."""
    scores, log_z = {}, {}
    for j, rows in picks.items():
        per = results[j]["per_sample"]
        log_z[j] = float(results[j]["log_partition"])
        for r in rows:
            scores[(j, r)] = float(per[r]) if r < len(per) else math.nan
    return scores, log_z


def reference_scores(prep, calls, picks, prec) -> tuple[dict, dict]:
    """The reference's (scores, log Z) of the same rows, in ``prec``."""
    tree, test = prep.tree, prep.test
    e, m = tree["eval"], tree["model"]
    vae = models.build_vae(m, prec).to(test.device)
    vae.load_state_dict(prep.w_vae)
    d = models.build_latent_d(tree, prec).to(test.device)
    d.load_state_dict(prep.w_d)
    scores, log_z = {}, {}
    for j, rows in picks.items():
        first, count, seed = calls[j]
        log_z[j] = reference.log_partition(d, m["z_dim"], seed, test.device)
        got = reference.scores(
            vae, d, test[first:first + count], rows, batch=e["batch_size"],
            k=e["iwae_k"], chunk=e["iwae_chunk"], seed=seed,
            likelihood=m["likelihood"],
            binary=bool(tree["data"]["binarize"]), log_z=log_z[j])
        scores.update({(j, r): s for r, s in got.items()})
    return scores, log_z


def gaps(prog: tuple[dict, dict], ref: tuple[dict, dict],
         stated: tuple[dict, dict]) -> dict:
    """``score_gap``: the worst gap of a score from the reference's, in
    units of the worst gap of the reference computed in the configuration's
    stated precision (``stated``) over the same images: how the weights
    amplify rounding differs from seed to seed, and this measure divides
    it out. ``log_z_gap``: the worst gap of a call's log Z."""
    def worst(got):
        return max(abs(got[0][key] - s_ref) for key, s_ref in ref[0].items())
    score_gap = worst(prog) / max(worst(stated), 1e-30)
    log_z_gap = max(abs(prog[1][j] - z) for j, z in ref[1].items())
    return {"score_gap": score_gap if math.isfinite(score_gap) else math.inf,
            "log_z_gap": log_z_gap if math.isfinite(log_z_gap)
            else math.inf}
