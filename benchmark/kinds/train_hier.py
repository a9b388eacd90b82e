"""Traffic kind ``train_hier``: the program's training loop on a
hierarchical VAE (the ``vdvae`` family), its train set resident on the
card, as users run it.

Set-up, in one process:

1. the train set (uint8, ``params.train_images`` images of the dataset's
   shape) and the VAE's weights are made from the seed on the card
   (``weights``); they enter the program as the checkpoint of step
   ``params.check_from_step`` (AdamW's moments zero, its counts at that
   step, none skipped, the EMA at the weights) that the loop resumes from,
   a step past the learning rate's warmup;
2. the loop's ``CHECK_STEPS`` steps from there, one step a call, each
   logged and checkpointed: what the reference follows
   (``reference/vdvae.py``);
3. three calls of ``steps_per_call`` steps: the warm-up, whose last call
   sizes the window.

The window, its timing, ``setup_s`` and the profiled stretch of ``--trace
1`` are ``train_loop``'s (``harness/train_window.py``): the rate is timed
between the loop's read-back points, over two record intervals at least
(a step of this family takes a third of a second, so one ``log_every``
interval may fill ``--seconds`` alone, and the recorder's readers leave
out the first). The port kernels in the profiled
stretch are the reparam kernel's learned-prior variant, one launch each way
a layer (``harness/hier_counts.py``), and the model FLOPs the reference's.

``correct``: after the window, the reference follows the same
``CHECK_STEPS`` steps from the same weights, batches and noise. Compared:
the first step's gradients as the optimizer takes them (clipped), read
from AdamW's first moments after one step (``grad_gap``), and the
parameters' change after the steps (``change_gap``), each the worst
leaf's gap against the larger of its reference norm and the median
leaf's, the change leaving out leaves whose reference gradient is under a
thousandth of the median's (``harness/check``); the EMA's change after the
steps (``ema_gap``), leaf by leaf as the parameters' change; over the
steps, the worst
relative gaps of the batch means of the rate, Σ_layers KL (``rate_gap``),
and of the distortion (``distortion_gap``), and the worst layer's gap of
its batch-mean KL against the larger of its reference value and the
median layer's (``layer_kl_gap``); and whether each step's update was
skipped alike (``skip_gap``: 0 when all agree, else 1). The steps' gradient
norms are printed in the notes: the checked steps must apply their
updates.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import time
from pathlib import Path

import torch

from benchmark.harness import check, hier_counts, seeded, tap, train_window
from benchmark.kinds import train_loop as flat
from benchmark.reference import vdvae as reference
from benchmark.reference.models import Precision

CHECK_STEPS = 3
B1 = 0.9                     # AdamW's first-moment decay
# the last convs of the posterior and prior branches, scaled from the
# published init's draw so that (qm, qs) spread by ~0.1 and (pm, ps) by
# ~0.05 at the cell's size: a KL of ~0.02 nats an element, which a KL
# that ignored pm or ps, or qs, would miss by far more than rounding
POSTERIOR_OUT_SCALE = 25.0
PRIOR_OUT_SCALE = 10.0


def weights(model_cfg: dict, seed: int, device) -> dict:
    """Float32 weights by name, drawn as the published init draws them
    (PyTorch's default conv init, U(±1/√fan_in)) from one draw of the
    seed's stream, each residual Block's last conv and each z_proj then
    scaled by √(1/n) as the published init scales them (n the blocks of
    their stack), the posterior's last conv by ``POSTERIOR_OUT_SCALE`` and
    the prior's, which the published init zeroes, by ``PRIOR_OUT_SCALE``:
    non-zero, so that a KL that ignored pm or ps differs, and a rate of a
    few nats a dimension, as a model in training has. Conv biases 0, the
    gain 1, the decoder's
    bias 0 and its per-resolution biases N(0, 0.1²). (He's N(0, 2/fan_in),
    which the flagship's cells take, makes the 43 layers' posterior scales
    grow from layer to layer until the KL overflows.)"""
    with torch.device("meta"):
        net = reference.VDVAE(model_cfg, Precision())
    params = dict(net.named_parameters())
    kernels = {n: p for n, p in params.items() if n.endswith(".weight")}
    gen = seeded.generator(seed, "vdvae", device)
    draw = torch.rand(sum(p.numel() for p in kernels.values()),
                      generator=gen, device=device) * 2.0 - 1.0
    n_enc = len(net.encoder.enc_blocks)
    n_dec = len(net.decoder.dec_blocks)
    out, at = {}, 0
    for name, p in params.items():
        if name in kernels:
            w = draw[at:at + p.numel()].view(p.shape)
            at += p.numel()
            w = w / math.prod(p.shape[1:]) ** 0.5
            if name.startswith("encoder.enc_blocks.") and ".c4." in name:
                w = w * (1.0 / n_enc) ** 0.5
            elif ".z_proj." in name or ".resnet.c4." in name:
                w = w * (1.0 / n_dec) ** 0.5
            elif ".prior.c4." in name:
                w = w * PRIOR_OUT_SCALE
            elif ".enc.c4." in name:
                w = w * POSTERIOR_OUT_SCALE
            out[name] = w
        elif name.startswith("decoder.bias_xs."):
            out[name] = 0.1 * torch.randn(p.shape, generator=gen,
                                          device=device)
        elif name == "decoder.gain":
            out[name] = torch.ones(p.shape, device=device)
        else:
            out[name] = torch.zeros(p.shape, device=device)
    return out


def program_readings(run_dir: Path, start: int, w: dict) -> dict:
    """The program's readings of the checked steps from step ``start``:
    its records (loss, distortion, rate, each layer's KL, the gradient
    norm, the cumulative skips), its first gradients (AdamW's first
    moments after one step) and its parameters' change after
    ``CHECK_STEPS`` steps."""
    recs = [json.loads(x) for x in
            (run_dir / "metrics.jsonl").read_text().splitlines() if x]
    by_step = {r["step"]: r for r in recs if "loss" in r}
    steps = flat._steps_of(run_dir / "checkpoints")
    one = torch.load(steps[start + 1], map_location="cpu",
                     weights_only=True)
    last = torch.load(steps[start + CHECK_STEPS], map_location="cpu",
                      weights_only=True)
    names = list(one["model"])
    grad = {n: float(torch.linalg.vector_norm(mu.double())) / (1.0 - B1)
            for n, mu in zip(names, one["opt"]["mu"])}

    def moved(saved):
        return {n: float(torch.linalg.vector_norm(p.double()
                                                  - w[n].cpu().double()))
                for n, p in saved.items()}
    checked = [by_step[s] for s in range(start, start + CHECK_STEPS)]
    skips = [r["skipped_updates"] for r in checked]
    before = [0.0] + skips[:-1]
    return {"loss": [r["loss"] for r in checked],
            "distortion": [r["distortion"] for r in checked],
            "rate": [r["rate"] for r in checked],
            "kl_layers": [r["kl_layers"] for r in checked],
            "grad_norm": [r["grad_norm"] for r in checked],
            "skipped": [s > b for s, b in zip(skips, before)],
            "grad": grad, "change": moved(last["model"]),
            "ema_change": moved(last["ema_model"])}


def readings_of(follow_out: dict, w: dict) -> dict:
    """A reference run's readings in the program's form."""
    def moved(after):
        return {n: float(torch.linalg.vector_norm((p - w[n]).double()))
                for n, p in after.items()}

    return {**{k: follow_out[k] for k in ("loss", "distortion", "rate",
                                          "kl_layers", "grad_norm",
                                          "skipped")},
            "grad": follow_out["grad"],
            "change": moved(follow_out["params"]),
            "ema_change": moved(follow_out["ema"])}


def _keyed(d: dict) -> dict:
    return {("vae", n): v for n, v in d.items()}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of ``correct``: program (or stand-in) readings against
    the reference's."""
    def rel(key):
        pairs = list(zip(prog[key], ref[key]))
        if not all(math.isfinite(a) for a, _ in pairs):
            return math.inf
        return max(abs(a - b) / max(abs(b), 1e-30) for a, b in pairs)

    def layer_gap():
        worst = 0.0
        for got, want in zip(prog["kl_layers"], ref["kl_layers"]):
            if len(got) != len(want):
                return math.inf
            mid = statistics.median(abs(v) for v in want)
            for a, b in zip(got, want):
                if not math.isfinite(a):
                    return math.inf
                worst = max(worst, abs(a - b) / max(abs(b), mid, 1e-30))
        return worst

    grad_gap, grad_leaf = check.leaf_gaps(_keyed(prog["grad"]),
                                          _keyed(ref["grad"]))
    still = check.negligible(_keyed(ref["grad"]))
    change_gap, change_leaf = check.leaf_gaps(
        _keyed(prog["change"]), _keyed(ref["change"]), exclude=still)
    ema_gap, ema_leaf = check.leaf_gaps(
        _keyed(prog["ema_change"]), _keyed(ref["ema_change"]), exclude=still)
    return {"numbers": {"grad_gap": grad_gap, "change_gap": change_gap,
                        "ema_gap": ema_gap,
                        "rate_gap": rel("rate"),
                        "distortion_gap": rel("distortion"),
                        "layer_kl_gap": layer_gap(),
                        "skip_gap": float(list(prog["skipped"])
                                          != list(ref["skipped"]))},
            "worst": {"grad_gap": grad_leaf, "change_gap": change_leaf,
                      "ema_gap": ema_leaf}}


class Prepared:
    """A run's set-up up to the checked steps (module docstring)."""

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
        self.w = weights(tree["model"], ctx.seed, dev)
        cfg = flat._config(ctx)
        self.run_dir = Path(cfg.results_dir) / cfg.name
        state = make_train_fns(cfg, device=dev).init_fn(cfg.train.seed)
        state.model.load_state_dict(self.w)
        if state.ema_model is not None:
            state.ema_model.load_state_dict(self.w)
        state.step = self.start
        state.opt.load_state_dict({"count": self.start,
                                   "mu": state.opt.mu, "nu": state.opt.nu})
        save_checkpoint(self.run_dir / "checkpoints", state, self.start)
        self.params = sum(t.numel() for t in self.w.values())

    def checked_steps(self) -> dict:
        from apv_tpu_torch.training.loop import train_loop
        with tap.RecordTap():
            train_loop(flat._config(self.ctx, steps_per_call=1, log_every=1,
                                    checkpoint_every=1),
                       max_steps=CHECK_STEPS, arrays=self.arrays,
                       resume=True, device=self.ctx.device)
        return program_readings(self.run_dir, self.start, self.w)

    def reference(self, prec=None, rows=None, fault=None) -> dict:
        return readings_of(reference.follow(
            self.tree, self.w, self.images, CHECK_STEPS, self.ctx.seed,
            prec, self.start, rows, fault), self.w)


def readings(ctx, control: bool) -> list[dict]:
    """The sound run's numbers and, with ``control``, the control's (the
    reference one precision step below, in the program's place) and the
    planted faults' (``reference/vdvae.FAULTS`` and half of each batch):
    the readings the limits are set from (``tools/kind_readings.py``)."""
    prep = Prepared(ctx)
    prog = prep.checked_steps()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    with ctx.reference_precision():
        ref = prep.reference()
        rows = [("program", prog)]
        if control:
            rows.append(("control", prep.reference(Precision("control"))))
            half = ctx.config_tree["train"]["batch_size"] // 2
            rows.append(("fault_half_batch", prep.reference(rows=half)))
            rows += [(f"fault_{f}", prep.reference(fault=f))
                     for f in reference.FAULTS]
    return [{"role": role, "grad_norm": got["grad_norm"],
             **compare(got, ref)["numbers"]} for role, got in rows]


def run(ctx) -> dict:
    t0 = time.perf_counter() - ctx.t0
    prep = Prepared(ctx)
    t1 = time.perf_counter() - ctx.t0
    first = prep.checked_steps()
    out = train_window.run(
        ctx, prep, check_steps=CHECK_STEPS,
        per_step=hier_counts.step_kernels(ctx.config_tree["model"],
                                          ctx.config_tree["train"]
                                          ["batch_size"]),
        flops_per_image=lambda: hier_counts.train_flops_per_image(
            ctx.config_tree))
    out["notes"]["setup_phases_s"].update(imported=t0, inputs_and_step0=t1)
    out["notes"].update(parameters=prep.params,
                        checked_grad_norms=first["grad_norm"])
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    with ctx.reference_precision():
        ref = prep.reference()
    cmp = compare(first, ref)
    out["numbers"] = cmp["numbers"]
    out["notes"]["worst_leaf"] = {k: str(v) for k, v in cmp["worst"].items()}
    out["notes"]["reference_grad_norms"] = ref["grad_norm"]
    return out
