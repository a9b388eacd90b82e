#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py                      # needs one CUDA card
    python3 chip_smoke.py --profile DIR        # also writes profiler tables
    python3 chip_smoke.py --quality-gate       # also the 3k-step CIFAR gate

Phases, one JSON line each:
  1. device: the card (nvidia-smi name and power limit), torch and CUDA
     versions, and the nvcc build of the kernels in apv_tpu_torch/ops/csrc.
  2. kernel: each hand-written kernel (forward and backward) against its
     plain PyTorch version on the card, at the shapes the paths give it,
     with its time, the plain version's time and the least time the card
     could take; disc_logistic and bernoulli at every path shape (x
     broadcast over the samples at the IWAE and OOD chunks, as the paths
     call them; the bound counts x once per image) and at odd lengths,
     disc_logistic with two rows in its t <= 1e-3 series in each case,
     each twice for the same bits, with their times at each path shape;
     reparam also at the OOD chunk and an odd shape, with its times at
     the OOD chunk and the train step; bernoulli_bwd also at
     257 rows and with dx; groupnorm_gelu and its backward
     also at shapes that take their other kernels, each twice for the
     same bits, each held to the kernel that ran;
     conv3x3 also at two odd shapes, one for each of its routes (tensor
     cores, SIMT), each held to the kernel that ran, and on views off
     TMA's alignment.
  3. scorer: the per-sample ELBO scorer of cifar_advprior_resnet at full
     width (batch 64, bf16 compute, random seeded weights) through the
     kernels, held to the same ELBO recomputed with the plain ops on the
     kernel path's z.
  4. iwae: the iwae_eval preset's k=1000 IWAE over one batch of 64 images
     to bits/dim, with the log-partition estimate of the learned prior.
  5. train: train_loop on mnist_advprior at full width (batch 256, bf16
     compute) for 48 steps in calls of steps_per_call=8, on a resident,
     bit-packed set of 60,000 seeded synthetic 28x28 images; exact launch
     counts per step, finite metrics and a falling loss; then one G step's
     gradients through the kernels held to the same step through the plain
     ops (f32 compute, deterministic cuDNN), and a second, timed run.
  6. mnist_scorer, 7. mnist_iwae: the scorer (batch 64) and IWAE k=1000,
     chunk 50, over one batch of 64 on the trained weights.
  8. cifar_train: train_loop on cifar_advprior_resnet at full width (batch
     256, bf16 compute) with no arrays=: the loaders' synthetic CIFAR-10
     (47,500 resident uint8 train rows, 2,500 valid rows), on-device
     dequantization, 24 steps in calls of 8 with validation and a
     checkpoint at step 24, a resume that restores it bit for bit, 24 more
     steps; exact launch counts, finite metrics, a falling loss; one G
     step's gradients through the kernels held to the plain ops; a timed
     run.
  9. cifar_ckpt: the step-48 checkpoint restored into a fresh state scores
     the same ELBO as the trained state in memory; then IWAE k=1000, chunk
     25, over the first 64 test images.
 10. groupnorm_gelu: the fused GroupNorm + GELU op, forward and backward
     through its autograd.Function, at the flagship's stage-1 shape
     [256, 32, 32, 64] in bf16 and f32 and at an odd shape, held to
     autograd of the plain version and to the kernels that must run.
 11. conv3x3: the conv probe (python -m apv_tpu_torch.ops.conv_probe) at its
     three shapes, bf16 and f32: the kernel's error against f32 F.conv2d,
     its chained time and cuDNN's.
 12. sample: the step-48 checkpoint through api.sample: 256 draws by SIR
     from the shaped prior (pool 4,096) and 20 MALA steps, the PNG grid
     read back, sample quality over 512 samples (mode "sample"); then the
     ex-post GMM prior (k=10).
 13. ood: api.ood_score on the ood_suite preset as it stands (cifar10 vs
     svhn, prior_ratio, k=100, chunk 50, 2,000 examples, batch 64), both
     directions, then score=complexity; exact launch counts.
 14. gb_train: cifar_gb (the trained Gaussian base under the adversarial
     D) through train_loop at full width, 24 steps in calls of 8 on the
     synthetic CIFAR set (loaded once for phases 14-16, 50,000 resident
     rows, no validation), β and the learning rate warmed over the first
     12; exact launches, finite metrics, a falling loss; ms a step from
     the loop's logger over a 48-step rerun at log_every=8, as phases 5
     and 8 time theirs; the step-24 checkpoint restored bit for bit, its
     scorer and IWAE k=1000, chunk 25, on 64 test images under its own
     prior, log Z drawn from the learned base; then api.sample, 256 draws by SIR over the base at
     temperature 1 and 0.7, each PNG read back.
 15. flow_train: cifar_flow (the trained RealNVP prior) likewise, IWAE
     with log Z exactly 0; api.sample from the flow at temperature 0.7,
     then prior='expost_flow' with its 2,000-step fit (its wall time).
 16. iwae_train: cifar_advprior_resnet with train.objective=iwae, k=5,
     DReG, 8 steps in one call: the decoder at 1,280 rows, the likelihood
     beside x's 256, reparam's backward summing 5 samples; exact
     launches, a falling loss, the peak of allocated memory, ms a step
     as in 14; one step's G gradients and loss through the kernels held
     to the objective written out with the kernels' plain versions on the
     same Philox draws.
Each path runs once with the launch counters zeroed just before it and
read just after; a kernel of the paths that did not launch fails the run.
The likelihood forwards' launches on the paths by (rows, x rows, E) are a
"launch_shapes" line (counted by this script's shims over the two
wrappers).
With --quality-gate, the reference's short gate follows: 3,000 steps of
cifar_advprior_resnet on the synthetic set, then IWAE k=100 on 512 test
images to bits/dim, with the active units and the wall time.
Then a {"kernels": [...]} line, the nvidia-smi line and, last, the
{"ok": true, ...} line. Any failed check exits nonzero without that line.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 64
DEVICE = "cuda"

# Published peaks (NVIDIA data sheets), dense, at the full power limit:
# memory bytes/s by card, and float32 operations/s outside the tensor cores.
MEM_BW = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12,
          "H200": 4.8e12}
F32_OPS = 67e12
BF16_TENSOR_OPS = 989e12       # dense bf16 on the tensor cores
TF32_TENSOR_OPS = 495e12       # dense TF32 on the tensor cores

# Per-element operation counts for the bounds, each transcendental counted
# as one operation: disc_logistic ~8 transcendentals + ~22 adds, multiplies
# and compares; reparam 10 Philox rounds of ~10 integer ops per 4 elements,
# Box-Muller and the affine; kl 2 + 4; bernoulli exp, log1p, max, abs, a
# multiply and two adds; bernoulli_bwd exp, add, divide, subtract,
# multiply; kl_bwd exp, subtract, three multiplies; reparam_bwd per sample
# two adds, a subtract and two multiplies; disc_logistic_bwd 4 exp (1/s,
# two sigmoids, expm1), 3 divides and ~23 adds, multiplies and compares.
# groupnorm_gelu two for the statistics, three to normalize and scale and
# ~8 for tanh-GELU; groupnorm_gelu_bwd ~25 (the GELU derivative, the four
# products and sums of the rule, the dx affine).
OPS_PER_ELEM = {"disc_logistic": 30, "reparam": 33, "kl": 6, "bernoulli": 7,
                "bernoulli_bwd": 5, "kl_bwd": 5, "reparam_bwd": 5,
                "disc_logistic_bwd": 30, "groupnorm_gelu": 13,
                "groupnorm_gelu_bwd": 25}

REPLACES = {
    "reparam": "apv_tpu/ops/kernels.py:305",
    "kl": "apv_tpu/ops/kernels.py:111",
    "disc_logistic": "apv_tpu/ops/kernels.py:211",
    "bernoulli": "apv_tpu/ops/kernels.py:149",
    "reparam_bwd": "apv_tpu/ops/kernels.py:348",
    "kl_bwd": "apv_tpu/ops/kernels.py:121",
    "bernoulli_bwd": "apv_tpu/ops/kernels.py:159",
    "disc_logistic_bwd": "apv_tpu/ops/kernels.py:223",
    "groupnorm_gelu": "apv_tpu/ops/groupnorm.py:116",
    "groupnorm_gelu_bwd": "apv_tpu/ops/groupnorm.py:166",
    "conv3x3": "scripts/conv_microbench.py:67",
}
# each kernel's __global__ functions, to find them in a profile
KERNEL_FNS = {"reparam": ("reparam_samples",), "kl": ("kl_rows",),
              "disc_logistic": ("disc_logistic_rows",),
              "bernoulli": ("bernoulli_rows",),
              "reparam_bwd": ("reparam_bwd_sum",),
              "kl_bwd": ("kl_bwd_rows",),
              "bernoulli_bwd": ("bernoulli_bwd_elems",),
              "disc_logistic_bwd": ("disc_logistic_bwd_rows",),
              "groupnorm_gelu": ("groupnorm_gelu_image",
                                 "groupnorm_gelu_rows"),
              "groupnorm_gelu_bwd": ("groupnorm_gelu_bwd_image",
                                     "groupnorm_gelu_bwd_rows"),
              "conv3x3": ("conv3x3_wgmma", "conv3x3_simt")}
SOURCES = {name: f"apv_tpu_torch/ops/csrc/{name.removesuffix('_bwd')}.cu"
           for name in REPLACES}

TRAIN_STEPS = 48           # six calls of the preset's steps_per_call=8
N_TRAIN_IMAGES = 60_000    # MNIST's train split
CIFAR_STEPS = 48           # 24, then 24 more after a resume
CIFAR_EVAL_EVERY = 24      # validation and checkpoint at steps 24 and 48
CIFAR_SPLIT = (47_500, 2_500)   # CIFAR-10's 50,000 at valid_fraction 0.05
GATE_STEPS = 3_000         # the reference's short quality gate
PRIOR_STEPS = 24           # cifar_gb and cifar_flow: three calls of 8
IWAE_STEPS = 8             # the IWAE objective: one call of 8
IWAE_K = 5                 # its samples a row (the preset's iwae_k)
FLOW_FIT_STEPS = 2_000     # the ex-post flow's fit, api.sample's default
TIMED_STEPS = 48           # a timed rerun: five logged calls of 8 steps


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def mem_bw(name: str) -> float:
    for key in sorted(MEM_BW, key=len, reverse=True):
        if key in name:
            return MEM_BW[key]
    return MEM_BW["H100"]


def bound(name: str, card: str, nbytes: int, elems: int) -> dict:
    t_bytes = nbytes / mem_bw(card)
    t_ops = OPS_PER_ELEM[name] * elems / F32_OPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def small_t_rows(log_scale: np.ndarray) -> None:
    """Rows 2 and 3 of a disc_logistic log_scale [rows, E] set where the
    bin's t = e^-ls / 255 reaches the forward's t <= 1e-3 series: ls 3.4
    to 5.5 (t 1.3e-4 down to 1.6e-5) and 1.2 to 1.5 (t 1.18e-3 down to
    8.8e-4, across the branch's edge)."""
    log_scale[2] = np.linspace(3.4, 5.5, log_scale.shape[1])
    log_scale[3] = np.linspace(1.2, 1.5, log_scale.shape[1])


def kernel_checks(K, card: str, dev) -> dict:
    rng = np.random.default_rng(SEED)
    results = {}
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa

    # disc_logistic at the IWAE chunk: mean and log_scale [chunk*B, H*W*C]
    # = [1600, 3072] beside the batch's x [64, 3072] (row r reads image
    # r % 64, as the path calls it)
    rows, event = 25 * BATCH, 3072
    x = rng.integers(0, 256, size=(rows, event)) / 255.0
    x[0, :256] = np.arange(256) / 255.0          # every level, edges too
    mean = rng.uniform(-0.2, 1.2, size=(rows, event))
    ls = rng.uniform(-7.0, 0.0, size=(rows, event))
    ls[1] = -7.0                                  # the decoder's floor
    small_t_rows(ls)
    x, mean, ls = (cuda(a.astype(np.float32)) for a in (x[:BATCH], mean, ls))
    # a row length that is not a multiple of 4 takes the scalar loop
    xo, mo, so = (rng.uniform(lo, hi, size=(7, 3073)).astype(np.float32)
                  for lo, hi in ((0, 1), (-0.2, 1.2), (-7, 0)))
    small_t_rows(so)
    xo, mo, so = map(cuda, (xo, mo, so))
    xo = torch.round(xo * 255) / 255
    # the OOD chunk [3200, 3072] beside x [64, 3072], the CIFAR train step
    # [256, 3072] with x unbroadcast, and the odd length with x broadcast
    # (S = 3), from a generator of their own (rng's later draws stay)
    rng_d = np.random.default_rng(SEED + 35)

    def disc_inputs(r, b, ev):
        xd = rng_d.integers(0, 256, size=(b, ev)) / 255.0
        xd[0, :256] = np.arange(256) / 255.0
        md = rng_d.uniform(-0.2, 1.2, size=(r, ev))
        sd = rng_d.uniform(-7.0, 0.0, size=(r, ev))
        sd[1] = -7.0
        small_t_rows(sd)
        return tuple(cuda(v.astype(np.float32)) for v in (xd, md, sd))

    cases = {"iwae_chunk": (x, mean, ls), "odd_length": (xo, mo, so),
             "ood_chunk": disc_inputs(50 * BATCH, BATCH, event),
             "train": disc_inputs(256, 256, event),
             "odd_length_broadcast": disc_inputs(21, 7, 3073),
             # the IWAE objective's k=5 decodings beside x [256, 3072]
             "iwae_train": disc_inputs(IWAE_K * 256, 256, event)}
    at = {}
    for tag, (xc, mc, sc) in cases.items():
        got = K.disc_logistic_cuda(xc, mc, sc)
        want = K.disc_logistic_plain(xc, mc, sc)
        err = float((got - want).abs().max())
        # f32 sums of 3072 terms in another order, plus an ulp or two per
        # transcendental: 1e-2 + 1e-5 x |sum|
        tol = 1e-2 + 1e-5 * float(want.abs().max())
        check(err <= tol, f"disc_logistic {tag}: max |kernel - plain| {err} "
              f"> {tol}")
        check(torch.equal(got, K.disc_logistic_cuda(xc, mc, sc)),
              f"disc_logistic {tag}: a second call gave other bits")
        r_, e_ = mc.shape
        at[tag] = {"shape": [r_, e_], "x_rows": xc.shape[0],
                   "max_abs_err": err, "tol": tol,
                   "max_abs_err_small_t": float(
                       (got - want)[2:4].abs().max()),
                   # mean and log_scale read once, x once per image
                   **bound("disc_logistic", card,
                           4 * (2 * r_ * e_ + xc.numel() + r_), r_ * e_)}
        if e_ == event:
            at[tag]["ms"] = cuda_ms(lambda: K.disc_logistic_cuda(xc, mc, sc),
                                    200)
    results["disc_logistic"] = {
        **at["iwae_chunk"],
        "max_abs_err_odd_length": at["odd_length"]["max_abs_err"],
        "plain_ms": cuda_ms(lambda: K.disc_logistic_plain(x, mean, ls), 20),
        "at": at}

    # kl at the scorer's [B, Z] = [64, 128]
    m = cuda(rng.normal(size=(BATCH, 128)).astype(np.float32))
    lv = cuda(rng.uniform(-4.0, 1.0, size=(BATCH, 128)).astype(np.float32))
    got, want = K.kl_cuda(m, lv), K.kl_plain(m, lv)
    err = float((got - want).abs().max())
    tol = 1e-4 + 1e-6 * float(want.abs().max())   # f32 sums of 128 terms
    check(err <= tol, f"kl: max |kernel - plain| {err} > {tol}")
    results["kl"] = {
        "shape": [BATCH, 128], "max_abs_err": err, "tol": tol,
        "ms": cuda_ms(lambda: K.kl_cuda(m, lv), 500),
        "plain_ms": cuda_ms(lambda: K.kl_plain(m, lv), 200),
        **bound("kl", card, 4 * (2 * BATCH * 128 + BATCH), BATCH * 128)}

    # reparam from [64, 128] to the IWAE chunk's [25, 64, 128], the OOD
    # chunk's [50, 64, 128], an odd shape whose total and row length are
    # not multiples of 4 (the scalar tail and the row wrap), and the IWAE
    # objective's [5, 256, 128] (its inputs from a generator of their own)
    seed, offset = 0x0123456789ABCDEF, 42
    rng_r = np.random.default_rng(SEED + 32)   # leaves rng's later draws
    odd = [cuda(rng_r.normal(size=(7, 5)).astype(np.float32)),
           cuda(rng_r.uniform(-4.0, 1.0, size=(7, 5)).astype(np.float32))]
    rng_5 = np.random.default_rng(SEED + 38)
    iw = [cuda(rng_5.normal(size=(256, 128)).astype(np.float32)),
          cuda(rng_5.uniform(-4.0, 1.0, size=(256, 128)).astype(np.float32))]
    rels = {}
    for tag, (mi, li, s_) in {"25x64x128": (m, lv, 25),
                              "50x64x128": (m, lv, 50),
                              "3x7x5": (*odd, 3),
                              f"{IWAE_K}x256x128": (*iw, IWAE_K)}.items():
        got = K.reparam_cuda(mi, li, s_, seed, offset)
        want = K.reparam_plain(mi, li, s_, seed, offset)
        rels[tag] = float(((got - want).abs() / (1.0 + want.abs())).max())
        # the same Philox words and f32 Box-Muller; libm ulps only
        check(rels[tag] <= 1e-5, f"reparam {tag}: max |kernel - plain|/"
              f"(1+|z|) {rels[tag]} > 1e-5")
        check(torch.equal(got, K.reparam_cuda(mi, li, s_, seed, offset)),
              f"reparam {tag}: the same (seed, offset) gave a different z")
    rel = rels["25x64x128"]
    got = K.reparam_cuda(m, lv, 25, seed, offset)
    want = K.reparam_plain(m, lv, 25, seed, offset)

    def eps_of(z):
        return ((z - m) / torch.exp(0.5 * lv)).reshape(-1).double()

    # moments over the k=1000 draws of one batch (8.2M normals)
    e = eps_of(K.reparam_cuda(m, lv, 1000, seed, offset + 1))
    mom = {"mean": float(e.mean()), "var": float(e.var()),
           "one_sigma_mass": float((e.abs() < 1.0).double().mean())}
    check(abs(mom["mean"]) <= 0.002, f"reparam: eps mean {mom['mean']}")
    check(abs(mom["var"] - 1.0) <= 0.003, f"reparam: eps var {mom['var']}")
    check(abs(mom["one_sigma_mass"] - 0.6827) <= 0.001,
          f"reparam: 1-sigma mass {mom['one_sigma_mass']}")

    def corr(a, b):
        return float(torch.corrcoef(torch.stack([a, b]))[0, 1])

    base = eps_of(got)
    corrs = {
        "next_chunk": corr(base, eps_of(K.reparam_cuda(m, lv, 25, seed,
                                                       offset + 1))),
        "next_seed": corr(base, eps_of(K.reparam_cuda(m, lv, 25, seed + 1,
                                                      offset))),
        # same thread's Box-Muller partner, the next thread, the next block
        "lag_1": corr(e[:-1], e[1:]), "lag_4": corr(e[:-4], e[4:]),
        "lag_1024": corr(e[:-1024], e[1024:]),
    }
    for what, c in corrs.items():
        check(abs(c) <= 0.01, f"reparam: eps correlation {what} = {c}")
    # the OOD chunk [50, 64, 128] (most of the paths' launches), the
    # CIFAR train step's S = 1 at [256, 128] and the IWAE objective's S = 5
    m_t = cuda(rng_r.normal(size=(256, 128)).astype(np.float32))
    lv_t = cuda(rng_r.uniform(-4.0, 1.0, size=(256, 128)).astype(np.float32))
    more = {}
    for tag, (mi, li, s_) in {"ood_chunk": (m, lv, 50),
                              "train": (m_t, lv_t, 1),
                              "iwae_train": (*iw, IWAE_K)}.items():
        more[tag] = {
            "shape": [s_, *mi.shape],
            "ms": cuda_ms(lambda: K.reparam_cuda(mi, li, s_, seed, offset),
                          500),
            **bound("reparam", card, 4 * (2 * mi.numel() + s_ * mi.numel()),
                    s_ * mi.numel())}
    results["reparam"] = {
        "shape": [25, BATCH, 128], "max_abs_err":
            float((got - want).abs().max()), "max_rel_err": rel,
        "max_rel_err_by_shape": rels,
        "moments_8.2M": mom, "correlations": corrs,
        "ms": cuda_ms(lambda: K.reparam_cuda(m, lv, 25, seed, offset), 500),
        "plain_ms": cuda_ms(lambda: K.reparam_plain(m, lv, 25, seed, offset),
                            50),
        **bound("reparam", card, 4 * (2 * BATCH * 128 + 25 * BATCH * 128),
                25 * BATCH * 128),
        "at": more}
    results.update(mnist_kernel_checks(K, card, rng, cuda))
    results.update(cifar_kernel_checks(K, card, rng, cuda))
    return results


def ulp_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (1 + |want|), elementwise."""
    return float(((got - want).abs() / (1.0 + want.abs())).max())


def mnist_kernel_checks(K, card: str, rng, cuda) -> dict:
    """The MNIST training path's kernels: bernoulli at the IWAE chunk (x
    broadcast over the samples), the train step and odd row lengths (x
    broadcast and not), each twice for the same bits, and the three
    backward kernels held
    to their plain formulas elementwise at 1e-6·(1 + |ref|): the same f32
    operations, libm ulps apart."""
    results = {}
    z_dim, tb, event = 40, 256, 784

    def bern_inputs(rows, ev):
        x = (rng.random((rows, ev)) < 0.2).astype(np.float32)
        logits = (3.0 * rng.normal(size=(rows, ev))).astype(np.float32)
        logits[0, :3] = (0.0, 60.0, -60.0)       # softplus' far branches
        return cuda(x), cuda(logits)

    # the MNIST IWAE chunk: logits [50*B, 784] beside the batch's x [64,
    # 784], as the path calls it; the train step [256, 784] and an odd row
    # length with x unbroadcast
    cases = {}
    for tag, (rows, ev) in (("iwae_chunk", (50 * BATCH, event)),
                            ("train", (tb, event)),
                            ("odd_length", (7, event + 1))):
        x, logits = bern_inputs(rows, ev)
        cases[tag] = (x[:BATCH] if tag == "iwae_chunk" else x, logits)
    xt, lt = cases["train"]
    # the odd length with x broadcast (S = 3), from a generator of its own
    rng_o = np.random.default_rng(SEED + 36)
    cases["odd_length_broadcast"] = (
        cuda((rng_o.random((7, event + 1)) < 0.2).astype(np.float32)),
        cuda((3.0 * rng_o.normal(size=(21, event + 1))).astype(np.float32)))
    at = {}
    for tag, (x, logits) in cases.items():
        got, want = K.bernoulli_cuda(x, logits), K.bernoulli_plain(x, logits)
        err = float((got - want).abs().max())
        # f32 sums of 784 terms in another order
        tol = 1e-4 + 1e-6 * float(want.abs().max())
        check(err <= tol, f"bernoulli {tag}: max |kernel - plain| {err} > "
              f"{tol}")
        check(torch.equal(got, K.bernoulli_cuda(x, logits)),
              f"bernoulli {tag}: a second call gave other bits")
        r_, e_ = logits.shape
        at[tag] = {"shape": [r_, e_], "x_rows": x.shape[0],
                   "max_abs_err": err, "tol": tol,
                   # the logits read once, x once per image
                   **bound("bernoulli", card, 4 * (r_ * e_ + x.numel() + r_),
                           r_ * e_)}
        if e_ == event:
            at[tag]["ms"] = cuda_ms(lambda: K.bernoulli_cuda(x, logits), 500)
    xi, li = cases["iwae_chunk"]
    results["bernoulli"] = {
        **at["iwae_chunk"], "max_abs_err_train": at["train"]["max_abs_err"],
        "max_abs_err_odd_length": at["odd_length"]["max_abs_err"],
        "plain_ms": cuda_ms(lambda: K.bernoulli_plain(xi, li), 50),
        "ms_train_shape": at["train"]["ms"], "at": at}

    # bernoulli_bwd at the train step, without dx as the path asks; with dx
    # on the odd length (the scalar loop)
    g = cuda(rng.normal(size=tb).astype(np.float32))
    _, dl = K.bernoulli_bwd_cuda(g, xt, lt, want_dx=False)
    dx_ref, dl_ref = K.bernoulli_bwd_plain(g, xt, lt)
    err = ulp_err(dl, dl_ref)
    xo, lo = bern_inputs(7, event + 1)
    go = cuda(rng.normal(size=7).astype(np.float32))
    dxo, dlo = K.bernoulli_bwd_cuda(go, xo, lo)
    err_odd = max(ulp_err(a, b) for a, b in
                  zip((dxo, dlo), K.bernoulli_bwd_plain(go, xo, lo)))
    check(max(err, err_odd) <= 1e-6, f"bernoulli_bwd: {err}, odd {err_odd}")
    # 257 rows without dx (an odd row count; every row's block also has
    # threads past the row's 196 float4s), and the train shape with dx
    # (the float4 route's dx stores), from a generator of their own so
    # that the checks after these see the data they did
    rng_b = np.random.default_rng(SEED + 34)
    more = {}
    for tag, rows_b, want_dx in (("257_rows", tb + 1, False),
                                 ("train_with_dx", tb, True)):
        xb = cuda((rng_b.random((rows_b, event)) < 0.2).astype(np.float32))
        lb = cuda((3.0 * rng_b.normal(size=(rows_b, event))).astype(
            np.float32))
        gb = cuda(rng_b.normal(size=rows_b).astype(np.float32))
        dxb, dlb = K.bernoulli_bwd_cuda(gb, xb, lb, want_dx=want_dx)
        ref_dx, ref_dl = K.bernoulli_bwd_plain(gb, xb, lb)
        more[tag] = max(ulp_err(a, b) for a, b in
                        ((dlb, ref_dl), (dxb, ref_dx)) if a is not None)
        check(more[tag] <= 1e-6, f"bernoulli_bwd {tag}: {more[tag]}")
    results["bernoulli_bwd"] = {
        "shape": [tb, event], "max_abs_err": float((dl - dl_ref).abs().max()),
        "max_rel_err": err, "max_rel_err_odd_length_with_dx": err_odd,
        **{f"max_rel_err_{tag}": e for tag, e in more.items()},
        "ms": cuda_ms(lambda: K.bernoulli_bwd_cuda(g, xt, lt, want_dx=False),
                      500),
        "plain_ms": cuda_ms(lambda: K.bernoulli_bwd_plain(g, xt, lt), 200),
        **bound("bernoulli_bwd", card, 4 * (tb + 3 * tb * event),
                tb * event)}

    # kl_bwd at the train step's [256, 40]
    m = cuda(rng.normal(size=(tb, z_dim)).astype(np.float32))
    lv = cuda(rng.uniform(-8.0, 8.0, size=(tb, z_dim)).astype(np.float32))
    got = K.kl_bwd_cuda(g, m, lv)
    want = K.kl_bwd_plain(g, m, lv)
    err = max(ulp_err(a, b) for a, b in zip(got, want))
    check(err <= 1e-6, f"kl_bwd: max rel err {err}")
    results["kl_bwd"] = {
        "shape": [tb, z_dim], "max_abs_err": max(
            float((a - b).abs().max()) for a, b in zip(got, want)),
        "max_rel_err": err,
        "ms": cuda_ms(lambda: K.kl_bwd_cuda(g, m, lv), 500),
        "plain_ms": cuda_ms(lambda: K.kl_bwd_plain(g, m, lv), 200),
        **bound("kl_bwd", card, 4 * (tb + 4 * tb * z_dim), tb * z_dim)}

    # reparam_bwd at the train step (S = 1, [256, 40]) and at S = 50
    res = {}
    for s_, b_ in ((1, tb), (50, BATCH)):
        mean = cuda(rng.normal(size=(b_, z_dim)).astype(np.float32))
        z = cuda(rng.normal(size=(s_, b_, z_dim)).astype(np.float32))
        gz = cuda(rng.normal(size=(s_, b_, z_dim)).astype(np.float32))
        got = K.reparam_bwd_cuda(gz, z, mean)
        want = K.reparam_bwd_plain(gz, z, mean)
        res[s_] = (max(ulp_err(a, b) for a, b in zip(got, want)),
                   max(float((a - b).abs().max()) for a, b in zip(got, want)),
                   (gz, z, mean))
        check(res[s_][0] <= 1e-6, f"reparam_bwd S={s_}: max rel err "
              f"{res[s_][0]}")
    # and at the IWAE objective's S = 5, [256, 128], from a generator of
    # its own
    rng_i = np.random.default_rng(SEED + 37)
    mi, zi, gi = (cuda(rng_i.normal(size=sh).astype(np.float32)) for sh in (
        (tb, 128), (IWAE_K, tb, 128), (IWAE_K, tb, 128)))
    got = K.reparam_bwd_cuda(gi, zi, mi)
    err_i = max(ulp_err(a, b) for a, b in zip(
        got, K.reparam_bwd_plain(gi, zi, mi)))
    check(err_i <= 1e-6, f"reparam_bwd iwae_train: max rel err {err_i}")
    ni = tb * 128
    at = {"iwae_train": {
        "shape": [IWAE_K, tb, 128], "max_rel_err": err_i,
        "ms": cuda_ms(lambda: K.reparam_bwd_cuda(gi, zi, mi), 500),
        **bound("reparam_bwd", card, 4 * (2 * IWAE_K * ni + ni + 2 * ni),
                IWAE_K * ni)}}
    gz, z, mean = res[1][2]
    n = tb * z_dim
    results["reparam_bwd"] = {
        "shape": [1, tb, z_dim], "max_abs_err": res[1][1],
        "max_rel_err": res[1][0], "max_rel_err_s50": res[50][0],
        "ms": cuda_ms(lambda: K.reparam_bwd_cuda(gz, z, mean), 500),
        "plain_ms": cuda_ms(lambda: K.reparam_bwd_plain(gz, z, mean), 200),
        **bound("reparam_bwd", card, 4 * (2 * n + n + 2 * n), n), "at": at}
    return results


def disc_logistic_bwd_err(got, want, g, x, mean, ls,
                          bin_size: float = 1.0 / 255.0) -> float:
    """max over outputs and elements of |got - want| / bar, where the bar
    is 1e-6·|g|·(1 + e^-ls + |a| + |b|): about 16 f32 ulps of the
    largest term that each output is made of (dmean sums inv_s·(1, σ(a),
    σ(b)); dlog_scale sums a·σ(a), b·(1 − σ(b)) and a t-term ≤ 1 + t, and
    at the −7 floor |a|, |b| reach ~10³ and cancel)."""
    xd, md, sd = x.double(), mean.double(), ls.double()
    inv_s = torch.exp(-sd)
    half = 0.5 * bin_size
    a, b = (xd - md + half) * inv_s, (xd - md - half) * inv_s
    bar = 1e-6 * g.double().abs()[:, None] * (1.0 + inv_s + a.abs()
                                               + b.abs())
    return max(float(((p.double() - q.double()).abs() / bar).max())
               for p, q in zip(got, want) if p is not None)


def cifar_kernel_checks(K, card: str, rng, cuda) -> dict:
    """disc_logistic_bwd at the train step's [256, 3072] without dx, as the
    path calls it, and with dx at an odd row length (the scalar loop), on
    every level, both edges, the −7 floor and the t <= 1e-4 series; then
    at the IWAE objective's [1280, 3072], x [256, 3072] repeated to the
    rows as the wrapper's caller does (``K.expand_rows``)."""
    def inputs(rows, event, rng=rng):
        x = rng.integers(0, 256, size=(rows, event)) / 255.0
        x[0, :256] = np.arange(256) / 255.0        # every level, edges too
        mean = rng.uniform(-0.2, 1.2, size=(rows, event))
        ls = rng.uniform(-7.0, 0.0, size=(rows, event))
        ls[1] = -7.0                               # the decoder's floor
        ls[2] = rng.uniform(5.0, 5.5, size=event)  # t <= 1e-4: the series
        ls[3] = rng.uniform(3.4, 4.0, size=event)  # t around 1e-4
        ls[4, :256] = -7.0
        x[4, :256] = np.arange(256) / 255.0        # every level at the floor
        g = rng.normal(size=rows)
        return tuple(cuda(v.astype(np.float32)) for v in (g, x, mean, ls))

    rows, event = 256, 3072
    g, x, mean, ls = inputs(rows, event)
    got = K.disc_logistic_bwd_cuda(g, x, mean, ls, want_dx=False)
    want = K.disc_logistic_bwd_plain(g, x, mean, ls)
    check(got[0] is None, "disc_logistic_bwd: dx written though not asked")
    err = disc_logistic_bwd_err(got, want, g, x, mean, ls)
    go, xo, mo, so = inputs(7, event + 1)
    got_o = K.disc_logistic_bwd_cuda(go, xo, mo, so)
    err_odd = disc_logistic_bwd_err(got_o, K.disc_logistic_bwd_plain(
        go, xo, mo, so), go, xo, mo, so)
    check(max(err, err_odd) <= 1.0, f"disc_logistic_bwd: max |kernel - "
          f"plain| / bar {err}, odd length with dx {err_odd} > 1")
    # the IWAE objective: k=5 rows of parameters per image, from a
    # generator of its own
    gi, xi, mi, si = inputs(IWAE_K * rows, event,
                            np.random.default_rng(SEED + 36))
    xi = K.expand_rows(xi[:rows].contiguous(), mi)
    got_i = K.disc_logistic_bwd_cuda(gi, xi, mi, si, want_dx=False)
    err_i = disc_logistic_bwd_err(got_i, K.disc_logistic_bwd_plain(
        gi, xi, mi, si), gi, xi, mi, si)
    check(err_i <= 1.0, f"disc_logistic_bwd iwae_train: max |kernel - "
          f"plain| / bar {err_i} > 1")
    ni = IWAE_K * rows * event
    # the bound counts x once per image, not the expanded copy the
    # wrapper is handed: a bound is of the function, not of a route
    at = {"iwae_train": {
        "shape": [IWAE_K * rows, event], "max_err_over_bar": err_i,
        "ms": cuda_ms(lambda: K.disc_logistic_bwd_cuda(
            gi, xi, mi, si, want_dx=False), 200),
        **bound("disc_logistic_bwd", card,
                4 * (IWAE_K * rows + 2 * ni + rows * event + 2 * ni), ni)}}
    n = rows * event
    return {"disc_logistic_bwd": {
        "shape": [rows, event], "max_abs_err": max(
            float((p - q).abs().max()) for p, q in zip(got[1:], want[1:])),
        "max_err_over_bar": err, "max_err_over_bar_odd_length_with_dx":
            err_odd,
        "bar": "1e-6*|g|*(1 + exp(-ls) + |a| + |b|) elementwise",
        "ms": cuda_ms(lambda: K.disc_logistic_bwd_cuda(
            g, x, mean, ls, want_dx=False), 500),
        "plain_ms": cuda_ms(lambda: K.disc_logistic_bwd_plain(
            g, x, mean, ls), 50),
        **bound("disc_logistic_bwd", card, 4 * (rows + 3 * n + 2 * n), n),
        "at": at}}


GN_SHAPE = (256, 32, 32, 64)   # the flagship's stage 1 at batch 256
GN_ODD = (3, 7, 5, 24)         # 3 channels a group, 35 pixels
# (shape, groups, the backward kernel that must run) beyond GN_SHAPE
# (image) and GN_ODD (rows)
GN_PATHS = (((2, 64, 64, 64), 8, "rows"),    # an image past eight blocks
            ((2, 12, 12, 192), 8, "image"),  # 24 or 48 runs a row, four blocks
            ((2, 3, 3, 257), 1, "rows"))     # 257 channels a group, two chunks


def gn_inputs(rng, shape, dtype, dev):
    c = shape[-1]
    x = torch.from_numpy((rng.normal(size=shape) * 2.0 + 0.3).astype(
        np.float32)).to(dev, dtype)
    g = torch.from_numpy((rng.normal(size=c) * 0.5 + 1.0).astype(
        np.float32)).to(dev)
    b = torch.from_numpy((rng.normal(size=c) * 0.1).astype(np.float32)).to(dev)
    dy = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dev, dtype)
    return x, g, b, dy


def scale_rel(got, want) -> float:
    """max |got - want| / max |want|, in f32."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# forward: max |kernel - plain| / max(max |y|, 1); gradients scale-relative
GN_FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
GN_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def library_gn_gelu(x, g, b):
    """F.group_norm + tanh F.gelu on the NCHW channels_last view of NHWC
    x, gamma and beta in x's dtype: the library's version of the op."""
    y = F.gelu(F.group_norm(x.permute(0, 3, 1, 2), 8, g.to(x.dtype),
                            b.to(x.dtype), 1e-6), approximate="tanh")
    return y.permute(0, 2, 3, 1)


def gn_kernel_checks(K, card: str, rng, dev) -> dict:
    """groupnorm_gelu and groupnorm_gelu_bwd against their plain versions
    at the flagship's stage-1 shape, an odd one and GN_PATHS, bf16 and
    f32, and on views off 16-byte alignment; each forward and each
    backward twice, for the same bits, each held to the kernel that must
    run there (image or rows, as the C entry points report it; one rule
    picks it for both).
    Times at the flagship shape in bf16 beside the library's
    F.group_norm + F.gelu (forward; backward alone on a retained graph;
    both), and the forward's in f32."""
    errs = {}

    def check_case(tag, x, g, b, dy, groups, kernel):
        K.reset_launches()
        with torch.inference_mode():
            yk, mk, rk = K.groupnorm_gelu_cuda(x, g, b, groups)
            fwd_again = K.groupnorm_gelu_cuda(x, g, b, groups)
            yp, mp, rp = K.groupnorm_gelu_plain(x, g, b, groups)
            ek = K.groupnorm_gelu_bwd_cuda(dy, x, g, b, mk, rk, groups)
            ep = K.groupnorm_gelu_bwd_plain(dy, x, g, b, mk, rk, groups)
            again = K.groupnorm_gelu_bwd_cuda(dy, x, g, b, mk, rk, groups)
        fwd = float((yk.float() - yp.float()).abs().max()) / max(
            float(yp.float().abs().max()), 1.0)
        stats = max(scale_rel(mk, mp), scale_rel(rk, rp))
        bwd = max(scale_rel(a, c) for a, c in zip(ek, ep))
        errs[tag] = {"fwd": fwd, "stats": stats, "bwd": bwd,
                     "fwd_max_abs": float((yk.float() - yp.float())
                                          .abs().max()),
                     "bwd_max_abs": max(float((a.float() - c.float())
                                              .abs().max())
                                        for a, c in zip(ek, ep))}
        check(fwd <= GN_FWD_TOL[x.dtype] and stats <= 1e-5,
              f"groupnorm_gelu {tag}: forward {fwd}, stats {stats}")
        check(bwd <= GN_GRAD_TOL[x.dtype],
              f"groupnorm_gelu_bwd {tag}: scale-relative {bwd}")
        check(all(torch.equal(a, c) for a, c in zip(ek, again)),
              f"groupnorm_gelu_bwd {tag}: a second call gave other bits")
        check(all(torch.equal(a, c) for a, c in zip((yk, mk, rk),
                                                    fwd_again)),
              f"groupnorm_gelu {tag}: a second call gave other bits")
        for key, name, routes in (
                ("fwd_kernel", "groupnorm_gelu", K.groupnorm_gelu_routes),
                ("bwd_kernel", "groupnorm_gelu_bwd",
                 K.groupnorm_gelu_bwd_routes)):
            ran = errs[tag][key] = dict(routes)
            check(ran == {**dict.fromkeys(K.GN_KERNELS, 0), kernel: 2},
                  f"{name} {tag}: launched {ran}, expected {name}_{kernel} "
                  "twice")

    for shape, kernel in ((GN_SHAPE, "image"), (GN_ODD, "rows")):
        for dtype in (torch.bfloat16, torch.float32):
            x, g, b, dy = gn_inputs(rng, shape, dtype, dev)
            check_case(f"{list(shape)} {str(dtype).removeprefix('torch.')}",
                       x, g, b, dy, 8, kernel)
    rng_p = np.random.default_rng(SEED + 33)   # leaves rng's later draws
    for shape, groups, kernel in GN_PATHS:
        for dtype in (torch.bfloat16, torch.float32):
            x, g, b, dy = gn_inputs(rng_p, shape, dtype, dev)
            check_case(f"{list(shape)} G={groups} "
                       f"{str(dtype).removeprefix('torch.')}",
                       x, g, b, dy, groups, kernel)
    # views one element off 16-byte alignment take the rows kernel
    x, g, b, dy = gn_inputs(rng_p, GN_PATHS[1][0], torch.bfloat16, dev)
    xs, dys = (torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:]
               .view(t.shape).copy_(t) for t in (x, dy))
    check_case(f"{list(x.shape)} G=8 bfloat16 off 16-byte alignment",
               xs, g, b, dys, 8, "rows")

    x, g, b, dy = gn_inputs(rng, GN_SHAPE, torch.bfloat16, dev)
    with torch.inference_mode():
        _, mk, rk = K.groupnorm_gelu_cuda(x, g, b, 8)
        fwd_ms = cuda_ms(lambda: K.groupnorm_gelu_cuda(x, g, b, 8), 200)
        fwd_plain = cuda_ms(lambda: K.groupnorm_gelu_plain(x, g, b, 8), 20)
        bwd_ms = cuda_ms(lambda: K.groupnorm_gelu_bwd_cuda(
            dy, x, g, b, mk, rk, 8), 200)
        bwd_plain = cuda_ms(lambda: K.groupnorm_gelu_bwd_plain(
            dy, x, g, b, mk, rk, 8), 20)
        lib_fwd = cuda_ms(lambda: library_gn_gelu(x, g, b), 200)
    xr, gr, br = (t.detach().requires_grad_(True) for t in (x, g, b))
    y_lib = library_gn_gelu(xr, gr, br)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        y_lib, (xr, gr, br), dy, retain_graph=True), 100)
    lib_both = cuda_ms(lambda: torch.autograd.grad(
        library_gn_gelu(xr, gr, br), (xr, gr, br), dy), 100)
    del y_lib
    x32, g32, b32, _ = gn_inputs(rng_p, GN_SHAPE, torch.float32, dev)
    with torch.inference_mode():
        fwd_ms_f32 = cuda_ms(lambda: K.groupnorm_gelu_cuda(x32, g32, b32, 8),
                             200)
        fwd_plain_f32 = cuda_ms(lambda: K.groupnorm_gelu_plain(
            x32, g32, b32, 8), 20)
    n = math.prod(GN_SHAPE)
    c = GN_SHAPE[-1]
    mb = 4 * (2 * c + 2 * GN_SHAPE[0] * 8)          # gamma, beta, mean, rstd
    first = errs[f"{list(GN_SHAPE)} bfloat16"]
    return {
        "groupnorm_gelu": {
            "shape": list(GN_SHAPE), "dtype": "bfloat16",
            "max_abs_err": first["fwd_max_abs"], "errs": errs,
            "tol_fwd": "1e-5 (f32), 2^-7 (bf16) x max(max|y|, 1)",
            "ms": fwd_ms, "plain_ms": fwd_plain, "library_ms": lib_fwd,
            "library": "F.group_norm + F.gelu(approximate='tanh'), forward",
            "ms_f32": fwd_ms_f32, "plain_ms_f32": fwd_plain_f32,
            "bound_ms_f32": bound("groupnorm_gelu", card, 2 * 4 * n + mb,
                                  n)["bound_ms"],
            **bound("groupnorm_gelu", card, 2 * 2 * n + mb, n)},
        "groupnorm_gelu_bwd": {
            "shape": list(GN_SHAPE), "dtype": "bfloat16",
            "max_abs_err": first["bwd_max_abs"],
            "tol": "scale-relative 1e-4 (f32), 1e-2 (bf16)",
            "ms": bwd_ms, "plain_ms": bwd_plain, "library_ms": lib_bwd,
            "library": "backward of F.group_norm + F.gelu on a retained "
                       "graph",
            "library_fwd_bwd_ms": lib_both,
            **bound("groupnorm_gelu_bwd", card, 3 * 2 * n + mb + 8 * c, n)},
    }


def conv_bound(card: str, shape, dtype) -> dict:
    """Bytes (x and w in, f32 out) over the memory rate, or the least time
    of the operations, whichever is larger: 2·9·Cin per output on the bf16
    tensor cores for bf16, as three TF32 products a MAC on the tensor
    cores for f32 (3xTF32, the least time of f32-exact work there). The
    same for either kernel: a bound of the function on the card."""
    b, h, w, cin, cout = shape
    size = 2 if dtype == torch.bfloat16 else 4
    outs = b * h * w * cout
    nbytes = size * (b * h * w * cin + 9 * cin * cout) + 4 * outs
    flops = 2 * 9 * cin * outs
    if dtype == torch.bfloat16:
        t_o = flops / BF16_TENSOR_OPS
    else:
        t_o = 3 * flops / TF32_TENSOR_OPS
    t_b = nbytes / mem_bw(card)
    return {"bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


# odd widths, one for each route: Cin 24 (a zero-filled K block) and Cout
# 40 (a partial N tile) on the tensor cores; Cin 13, Cout 20 on SIMT
CONV_ODD = [((2, 9, 11, 24, 40), "wgmma"), ((3, 7, 5, 13, 20), "simt")]


def check_misaligned(K, x, w, want) -> None:
    """x and w as views one element off TMA's 16-byte alignment: the
    wrapper copies them and runs the tensor-core kernel, with the same
    result."""
    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view
    xs, ws = shifted(x), shifted(w)
    check(xs.data_ptr() % 16 != 0 and ws.data_ptr() % 16 != 0,
          "conv3x3: the shifted views are aligned")
    K.reset_launches()
    got = K.conv3x3_cuda(xs, ws)
    check(K.conv3x3_routes == {"wgmma": 1, "simt": 0} and bool(
        torch.equal(got, want)), f"conv3x3 misaligned {tuple(x.shape)} "
          f"{x.dtype}: launched {K.conv3x3_routes}, equal "
          f"{bool(torch.equal(got, want))}")


def conv_kernel_checks(K, card: str, rng, dev) -> dict:
    """conv3x3 against its plain version and against f32 F.conv2d (TF32
    off) at the probe's three shapes and the two odd ones, bf16 and f32;
    times of the kernel, the plain version and cuDNN (F.conv2d in the
    input's dtype) per shape. The kernels line takes the first shape in
    bf16."""
    from apv_tpu_torch.ops.conv_probe import SHAPES, torch_conv
    per_shape = []
    cases = [(tuple(s), "wgmma") for s in SHAPES] + CONV_ODD
    for shape, route in cases:
        b, h, w, cin, cout = shape
        xf = torch.from_numpy(rng.normal(size=(b, h, w, cin)).astype(
            np.float32)).to(dev)
        wf = torch.from_numpy((rng.normal(size=(3, 3, cin, cout)) * 0.05)
                              .astype(np.float32)).to(dev)
        with torch.inference_mode():
            ref = torch_conv(xf, wf)
            for dtype in (torch.bfloat16, torch.float32):
                x, wt = xf.to(dtype), wf.to(dtype)
                K.reset_launches()
                got = K.conv3x3_cuda(x, wt)
                check(K.conv3x3_routes == {"wgmma": 0, "simt": 0, route: 1},
                      f"conv3x3 {shape} {dtype}: launched "
                      f"{K.conv3x3_routes}, expected {route}")
                if route == "wgmma" and shape == CONV_ODD[0][0]:
                    check_misaligned(K, x, wt, got)
                plain = K.conv3x3_plain(x, wt)
                check(got.shape == plain.shape and bool(
                    torch.isfinite(got).all()), f"conv3x3 {shape} {dtype}: "
                      "shape or non-finite values")
                rel = scale_rel(got, ref)
                tol = 1e-5 if dtype == torch.float32 else 1e-2
                check(rel <= tol, f"conv3x3 {shape} {dtype}: error against "
                      f"f32 F.conv2d {rel} > {tol}")
                vs_plain = scale_rel(got, plain)
                check(vs_plain <= 1e-5, f"conv3x3 {shape} {dtype}: against "
                      f"its plain version {vs_plain} > 1e-5")
                per_shape.append({
                    "shape": list(shape), "route": route,
                    "dtype": str(dtype).removeprefix("torch."),
                    "rel_err_vs_f32": rel, "rel_err_vs_plain": vs_plain,
                    "max_abs_err": float((got - plain).abs().max()),
                    "ms": cuda_ms(lambda: K.conv3x3_cuda(x, wt), 20),
                    "plain_ms": cuda_ms(lambda: K.conv3x3_plain(x, wt), 5),
                    "library_ms": cuda_ms(lambda: torch_conv(x, wt), 50),
                    **conv_bound(card, shape, dtype)})
            del ref, got, plain
    head = per_shape[0]
    return {"conv3x3": {
        **{k: head[k] for k in ("shape", "dtype", "max_abs_err", "ms",
                                "plain_ms", "library_ms", "bound_ms",
                                "bound_by")},
        "library": "F.conv2d (cuDNN) on the channels_last view, input dtype",
        "tol": "relative to max|F.conv2d f32|: 1e-5 (f32), 1e-2 (bf16); "
               "relative to max|plain|: 1e-5",
        "per_shape": per_shape}}


# ---------------------------------------------------------------------------
# phases 3-4 and 6-7: the scorer and IWAE k=1000 on one batch
# ---------------------------------------------------------------------------

# the likelihood forwards' launches on the paths by (name, (rows, x rows,
# E)): those since the last reset, and their sum over the paths read
SHAPES_NOW: collections.Counter = collections.Counter()
PATH_SHAPES: collections.Counter = collections.Counter()


def count_shapes(K) -> None:
    """From here on, count each launch of the two likelihood forwards by
    shape into SHAPES_NOW, which ``K.reset_launches`` clears with the
    launch counts: shims over the wrappers, in this script only (the
    wrappers count launches, not shapes)."""
    reset = K.reset_launches

    def reset_both():
        reset()
        SHAPES_NOW.clear()

    def shim(name, wrapper):
        def run(x, params, *rest, **kw):
            out = wrapper(x, params, *rest, **kw)
            if params.shape[0]:              # a launch (no rows: none)
                SHAPES_NOW[(name, (params.shape[0], x.shape[0],
                                   params.shape[1]))] += 1
            return out
        return run

    K.reset_launches = reset_both
    K.bernoulli_cuda = shim("bernoulli", K.bernoulli_cuda)
    K.disc_logistic_cuda = shim("disc_logistic", K.disc_logistic_cuda)


def path_counts(K) -> dict:
    """The launch counts of the path just run (zeroed just before it), its
    likelihood launches by shape added to PATH_SHAPES."""
    PATH_SHAPES.update(SHAPES_NOW)
    return dict(K.launches)


def expected(K, **counts) -> dict:
    """A full launch-count dict: the named kernels at their counts, the
    rest at 0."""
    return {name: counts.get(name, 0) for name in K.launches}


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def plain_elbo(cfg, model, d, x, log_z, seed):
    """The scorer's ELBO with the plain ops, on the kernel path's z."""
    from apv_tpu_torch import ops
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.training.losses import \
        decoder_output_to_likelihood_params
    with torch.inference_mode():
        x_in = x if cfg.data.binarize else x * 2.0 - 1.0
        mean, logvar = model.encode(x_in)
        z = ops.reparam_sample(mean, logvar, generator=gen(seed))
        params = decoder_output_to_likelihood_params(
            model.decode(z), cfg.model.likelihood, x.shape[-1])
        recon = (K.bernoulli_plain(x, *params)
                 if cfg.model.likelihood == "bernoulli"
                 else K.disc_logistic_plain(x, *params))
        return recon - K.kl_plain(mean, logvar) + d(z) - log_z


def scorer_phase(phase, cfg, model, d, x, dev):
    """One scorer batch with the counters zeroed around it, held to the
    plain ops; then 20 timed batches. Returns (launches, ELBO as numpy)."""
    from apv_tpu_torch import make_scorer
    from apv_tpu_torch.eval.iwae_eval import estimate_log_partition
    from apv_tpu_torch.ops import kernels as K
    with torch.inference_mode():
        log_z, log_z_se = estimate_log_partition(
            d, cfg.model.z_dim, seed=SEED + 17, with_se=True, device=dev)
    log_z = float(log_z)
    scorer = make_scorer(cfg, model, d, log_z, device=dev)
    scorer(x, generator=gen(99))                            # warm up
    torch.cuda.synchronize()

    K.reset_launches()
    elbo = scorer(x, generator=gen(SEED))
    torch.cuda.synchronize()
    launches = path_counts(K)
    recon = "bernoulli" if cfg.model.likelihood == "bernoulli" \
        else "disc_logistic"
    check(launches == expected(K, reparam=1, kl=1, **{recon: 1}),
          f"{phase} launches {launches}")
    check(elbo.shape == (x.shape[0],) and bool(torch.isfinite(elbo).all()),
          f"{phase}: ELBO not finite or of the wrong shape")
    elbo_plain = plain_elbo(cfg, model, d, x, log_z, SEED)
    err = float((elbo - elbo_plain).abs().max())
    # the same decoder output, kernel vs plain sums: as phase 2's bars
    tol = 5e-2 + 1e-5 * float(elbo_plain.abs().max())
    check(err <= tol, f"{phase}: max |ELBO - plain ELBO| {err} > {tol}")
    iters = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        scorer(x, generator=gen(i))
    torch.cuda.synchronize()
    scorer_s = (time.perf_counter() - t0) / iters
    elbo_np = elbo.double().cpu().numpy()
    emit(phase, preset=cfg.name, batch=x.shape[0], launches=launches,
         elbo_mean=float(elbo_np.mean()), elbo_std=float(elbo_np.std()),
         max_abs_err_vs_plain=err, tol=tol, log_partition=log_z,
         log_partition_se=float(log_z_se), ms_per_batch=scorer_s * 1e3,
         images_per_s=x.shape[0] / scorer_s)
    return launches, elbo_np


def iwae_phase(phase, cfg, model, d, images, elbo_np, chunk_want, dev,
               want_log_z: float | None = None):
    """evaluate_nll over one batch at k=1000 with the counters zeroed
    around it; IWAE mean >= ELBO mean - SE (and, given ``want_log_z``, its
    log-partition estimate is that); then a timed repeat."""
    from apv_tpu_torch import evaluate_nll
    from apv_tpu_torch.ops import kernels as K
    k, chunk = cfg.eval.iwae_k, cfg.eval.iwae_chunk
    check((k, chunk) == (1000, chunk_want), f"{cfg.name} preset has k={k}, "
          f"chunk={chunk}")
    batch = len(images)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = evaluate_nll(cfg, model, d, images, k=k, chunk=chunk,
                       batch_size=batch, seed=SEED, per_sample=True,
                       device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_counts(K)
    recon = "bernoulli" if cfg.model.likelihood == "bernoulli" \
        else "disc_logistic"
    check(launches == expected(K, reparam=k // chunk, **{recon: k // chunk}),
          f"{phase} launches {launches}")
    per = np.asarray(res.pop("per_sample"))
    check(per.shape == (batch,) and np.all(np.isfinite(per))
          and math.isfinite(res["bits_per_dim"]), f"{phase}: not finite")
    if want_log_z is not None:
        check(abs(res["log_partition"] - want_log_z)
              <= 1e-6 * max(1.0, abs(want_log_z)),
              f"{phase}: log Z {res['log_partition']}, want {want_log_z}")
    margin = elbo_np.std(ddof=1) / math.sqrt(batch)
    check(per.mean() >= elbo_np.mean() - margin,
          f"{phase}: iwae mean {per.mean()} below ELBO mean "
          f"{elbo_np.mean()} - {margin}")
    t0 = time.perf_counter()
    evaluate_nll(cfg, model, d, images, k=k, chunk=chunk, batch_size=batch,
                 seed=SEED + 1, device=dev)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    emit(phase, preset=cfg.name, k=k, chunk=chunk, batch=batch,
         launches=launches, **res, elbo_mean=float(elbo_np.mean()),
         iwae_mean=float(per.mean()), wall_s_first=wall, wall_s=wall2,
         images_per_s=batch / wall2)
    return launches


# ---------------------------------------------------------------------------
# phase 5: training mnist_advprior
# ---------------------------------------------------------------------------

def synthetic_digits(n: int, seed: int) -> np.ndarray:
    """Seeded stand-ins for MNIST digits, uint8 [n, 28, 28, 1]: two soft
    strokes (elongated Gaussian blobs at random centres and angles) on a
    black ground, so most pixels binarize to 0 as MNIST's do."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    out = np.empty((n, 28, 28, 1), np.uint8)
    for lo in range(0, n, 10_000):
        m = min(10_000, n - lo)
        img = np.zeros((m, 28, 28), np.float32)
        for _ in range(2):
            cy, cx = rng.uniform(8, 20, (2, m, 1, 1)).astype(np.float32)
            ang = rng.uniform(0, np.pi, (m, 1, 1)).astype(np.float32)
            long_, short = rng.uniform(3, 7, (m, 1, 1)), rng.uniform(1, 2, (
                m, 1, 1))
            u = (yy - cy) * np.cos(ang) + (xx - cx) * np.sin(ang)
            v = -(yy - cy) * np.sin(ang) + (xx - cx) * np.cos(ang)
            img = np.maximum(img, np.exp(-0.5 * ((u / long_) ** 2
                                                 + (v / short) ** 2)))
        out[lo:lo + m, ..., 0] = np.round(255.0 * img).astype(np.uint8)
    return out


def train_config(results_dir: str, log_every: int):
    from apv_tpu_torch import apply_overrides, get_preset
    return apply_overrides(get_preset("mnist_advprior"), [
        f"results_dir={results_dir}", f"train.log_every={log_every}"])


def read_metrics(cfg) -> list[dict]:
    path = Path(cfg.results_dir) / cfg.name / "metrics.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def run_train(cfg, arrays, dev):
    """train_loop for TRAIN_STEPS steps; the logger's per-step lines go to
    a buffer (they are in metrics.jsonl)."""
    from apv_tpu_torch import train_loop
    with contextlib.redirect_stdout(io.StringIO()):
        state = train_loop(cfg, max_steps=TRAIN_STEPS, arrays=arrays,
                           device=dev)
    torch.cuda.synchronize()
    return state


def loop_step_s(cfg, arrays, dev) -> float:
    """Mean seconds a step of ``train_loop(cfg)`` over ``arrays``, as the
    loop's logger times it (``cfg`` logs every 8 steps: one read-back per
    call of 8)."""
    from apv_tpu_torch import train_loop
    with contextlib.redirect_stdout(io.StringIO()):
        train_loop(cfg, arrays=arrays, device=dev)
    torch.cuda.synchronize()
    return float(np.mean([r["step_time_s"] for r in read_metrics(cfg)
                          if "step_time_s" in r]))


def grad_check(cfg, state, x_in, x_target, dev, phase="train") -> dict:
    """One G step's gradients through the kernels against the same step
    through the plain ops, on the same noise: the plain Philox stream
    reproduces the kernel's ε. f32 compute and deterministic cuDNN, so the
    two differ only by the kernels' rounding (in bf16 a z one ulp apart
    can round to another bf16 value and move every later layer)."""
    from apv_tpu_torch import build_model
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.training.losses import \
        decoder_output_to_likelihood_params
    from apv_tpu_torch.training.step import _loss_scale, g_objective
    torch.backends.cudnn.deterministic = True
    try:
        m32 = build_model(cfg.model, dtype=torch.float32, device=dev)
        m32.load_state_dict(state.model.state_dict())
        params = list(m32.parameters())
        beta = 1.0
        loss_k, _, _ = g_objective(cfg, m32, state.d, x_in, x_target, beta,
                                   generator=gen(SEED + 5))
        grads_k = torch.autograd.grad(loss_k, params)

        mean, logvar = m32.encode(x_in)
        z = K.reparam_plain(mean, logvar, 1, *K.draw_key(gen(SEED + 5)))[0]
        lik = decoder_output_to_likelihood_params(
            m32.decode(z), cfg.model.likelihood, x_target.shape[-1])
        recon = (K.bernoulli_plain(x_target, *lik)
                 if cfg.model.likelihood == "bernoulli"
                 else K.disc_logistic_plain(x_target, *lik))
        adv = cfg.adversarial.weight * beta * state.d(z)
        loss_p = -((recon + adv).mean() - beta * K.kl_plain(
            mean, logvar).mean()) * _loss_scale(cfg)
        grads_p = torch.autograd.grad(loss_p, params)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(grads_k, grads_p))
    check(rel <= 1e-3, f"{phase}: G gradients kernels vs plain, "
          f"scale-relative {rel} > 1e-3")
    return {"grad_max_scale_rel_err": rel,
            "loss_kernels": float(loss_k.detach()),
            "loss_plain": float(loss_p.detach())}


def train_phase(dev, tmp: str):
    """Returns (launches of the checked run, trained state, cfg)."""
    from apv_tpu_torch.data.preprocess import pack_bits, static_binarize
    from apv_tpu_torch.ops import kernels as K
    cfg = train_config(tmp, log_every=1)
    t0 = time.perf_counter()
    bits = static_binarize(synthetic_digits(N_TRAIN_IMAGES, SEED + 3),
                           seed=cfg.train.seed)
    arrays = {"image_packed": pack_bits(bits)}
    data_s = time.perf_counter() - t0
    check(cfg.train.steps_per_call == 8 and TRAIN_STEPS % 8 == 0
          and cfg.data.device_resident and cfg.data.bit_pack,
          "mnist_advprior preset: expected resident packed data, k=8")

    K.reset_launches()
    t0 = time.perf_counter()
    state = run_train(cfg, arrays, dev)
    wall_checked = time.perf_counter() - t0
    launches = path_counts(K)
    per_step = {"reparam": 1, "kl": 1, "bernoulli": 1, "reparam_bwd": 1,
                "kl_bwd": 1, "bernoulli_bwd": 1}
    check(launches == expected(K, **{n: TRAIN_STEPS * c
                                     for n, c in per_step.items()}),
          f"train launches {launches}")
    records = read_metrics(cfg)
    check([r["step"] for r in records] == list(range(TRAIN_STEPS)),
          "train: one metrics line per step")
    check(all(math.isfinite(v) for r in records for v in r.values()),
          "train: a metric is not finite")
    loss = [r["loss"] for r in records]
    first, last = float(np.mean(loss[:8])), float(np.mean(loss[-8:]))
    check(last < first, f"train: mean loss of the last 8 steps {last} not "
          f"below the first 8 {first}")

    x = torch.from_numpy(bits[:256].astype(np.float32)).to(dev)
    grads = grad_check(cfg, state, x, x, dev)

    # timed run: one read-back per call of 8 steps, as the loop logs
    cfg_t = dataclasses.replace(cfg, name=cfg.name + "_timed",
                                train=dataclasses.replace(cfg.train,
                                                          log_every=8))
    run_train(cfg_t, arrays, dev)
    dts = [r["step_time_s"] for r in read_metrics(cfg_t)
           if "step_time_s" in r]
    step_s = float(np.mean(dts))
    last_rec = records[-1]
    emit("train", preset=cfg.name, batch=cfg.train.batch_size,
         steps=TRAIN_STEPS, steps_per_call=cfg.train.steps_per_call,
         n_images=N_TRAIN_IMAGES, packed_bytes=int(arrays[
             "image_packed"].nbytes), data_prep_s=data_s,
         launches=launches, loss_first8=first, loss_last8=last,
         last_step={k: last_rec[k] for k in (
             "loss", "recon", "kl", "elbo", "g_adv", "grad_norm", "d_loss",
             "d_acc")},
         wall_s_checked_run=wall_checked, step_time_s=step_s,
         steps_per_s=1.0 / step_s,
         images_per_s=cfg.train.batch_size / step_s, **grads)
    return launches, state, cfg


# ---------------------------------------------------------------------------
# phases 8-9: training cifar_advprior_resnet, then its checkpoint
# ---------------------------------------------------------------------------

def cifar_config(results_dir: str, *extra: str):
    """The flagship preset with its schedule cut to CIFAR_STEPS (warm-up
    over the first half, cosine decay over the second)."""
    from apv_tpu_torch import apply_overrides, get_preset
    return apply_overrides(get_preset("cifar_advprior_resnet"), [
        f"results_dir={results_dir}", "train.log_every=1",
        f"train.steps={CIFAR_STEPS}", f"train.eval_every={CIFAR_EVAL_EVERY}",
        f"train.checkpoint_every={CIFAR_EVAL_EVERY}", *extra])


def states_equal(a, b) -> bool:
    """Bit equality of two TrainStates: step, seed, parameters, buffers and
    both optimizers' counts and moments."""
    def flat(st):
        sd = st.state_dict()
        out = [sd["step"], sd["seed"], sd["opt"]["count"]]
        tensors = [*sd["model"].values(), *sd["opt"]["mu"],
                   *sd["opt"]["nu"]]
        if "d" in sd:
            out.append(sd["d_opt"]["count"])
            tensors += [*sd["d"].values(), *sd["d_opt"]["mu"],
                        *sd["d_opt"]["nu"]]
        return out, tensors
    (ha, ta), (hb, tb) = flat(a), flat(b)
    return ha == hb and len(ta) == len(tb) and all(
        x.dtype == y.dtype and torch.equal(x, y.to(x.device))
        for x, y in zip(ta, tb))


def cifar_train_phase(dev, tmp: str):
    """Returns (launches of the checked runs, trained state, cfg)."""
    from apv_tpu_torch import latest_step, train_loop
    from apv_tpu_torch.data.preprocess import (normalize_center,
                                               uniform_dequantize)
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.training.loop import load_train_arrays
    cfg = cifar_config(tmp)
    k, half = cfg.train.steps_per_call, CIFAR_STEPS // 2
    check(k == 8 and cfg.data.device_resident and cfg.data.dequantize
          and cfg.adversarial.d_reuse_posterior,
          "cifar_advprior_resnet preset: expected resident dequantized "
          "data, k=8, D on the G phase's posterior")
    t0 = time.perf_counter()
    train_arrays, valid_arrays = load_train_arrays(cfg)
    data_s = time.perf_counter() - t0
    n_train, n_valid = len(train_arrays["image"]), len(valid_arrays["image"])
    check((n_train, n_valid) == CIFAR_SPLIT
          and train_arrays["image"].dtype == np.uint8,
          f"cifar10 train/valid split {n_train}/{n_valid}")
    valid_batches = n_valid // min(cfg.train.batch_size, n_valid)

    K.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        state24 = train_loop(cfg, max_steps=half, device=dev)
        torch.cuda.synchronize()
        wall_first = time.perf_counter() - t0
        ckpt_dir = Path(tmp) / cfg.name / "checkpoints"
        check(latest_step(ckpt_dir) == half, f"cifar_train: checkpoint "
              f"steps {latest_step(ckpt_dir)} after {half} steps")
        # the resumed state before its first step: the loop's own resume
        # with nothing left to run
        resumed = train_loop(cfg, max_steps=0, resume=True, device=dev)
        check(resumed.step == half and states_equal(resumed, state24),
              "cifar_train: the resumed state differs from the step-24 "
              "checkpoint's")
        del resumed
        t0 = time.perf_counter()
        state = train_loop(cfg, max_steps=half, resume=True, device=dev)
        torch.cuda.synchronize()
        wall_second = time.perf_counter() - t0
    launches = path_counts(K)
    per_step = {"reparam": 1, "kl": 1, "disc_logistic": 1, "reparam_bwd": 1,
                "kl_bwd": 1, "disc_logistic_bwd": 1}
    per_valid = {"reparam": 1, "kl": 1, "disc_logistic": 1}
    want = {n: CIFAR_STEPS * per_step.get(n, 0)
            + 2 * valid_batches * per_valid.get(n, 0) for n in K.launches}
    check(launches == want, f"cifar_train launches {launches}, want {want}")
    check(state.step == CIFAR_STEPS and latest_step(ckpt_dir) == CIFAR_STEPS,
          "cifar_train: final step or checkpoint")

    records = read_metrics(cfg)
    train_recs = [r for r in records if "loss" in r]
    valid_recs = [r for r in records if "valid_elbo" in r]
    check([r["step"] for r in train_recs] == list(range(CIFAR_STEPS)),
          "cifar_train: one metrics line per step 0..47")
    check([r["step"] for r in valid_recs] == [half, CIFAR_STEPS],
          f"cifar_train: validation at {[r['step'] for r in valid_recs]}")
    check(all(math.isfinite(v) for r in records for v in r.values()),
          "cifar_train: a metric is not finite")
    best = json.loads((Path(tmp) / cfg.name / "best.json").read_text())
    check(best["valid_elbo"] == max(r["valid_elbo"] for r in valid_recs),
          "cifar_train: best.json is not the best validation")
    loss = [r["loss"] for r in train_recs]
    first, last = float(np.mean(loss[:8])), float(np.mean(loss[-8:]))
    check(last < first, f"cifar_train: mean loss of the last 8 steps {last} "
          f"not below the first 8 {first}")

    image = torch.from_numpy(
        valid_arrays["image"][:cfg.train.batch_size]).to(dev)
    u = torch.rand(image.shape, generator=torch.Generator(dev).manual_seed(
        SEED + 7), device=dev)
    x_in = normalize_center(uniform_dequantize(image, u=u))
    grads = grad_check(cfg, state, x_in, image.to(torch.float32) / 255.0, dev,
                       phase="cifar_train")

    # timed run on the train set already loaded: one read-back per call
    # of 8 steps, no validation
    cfg_t = cifar_config(tmp, f"name={cfg.name}_timed", "train.log_every=8",
                         "train.eval_every=0")
    step_s = loop_step_s(cfg_t, train_arrays, dev)
    last_rec = train_recs[-1]
    emit("cifar_train", preset=cfg.name, batch=cfg.train.batch_size,
         steps=CIFAR_STEPS, steps_per_call=k, n_train=n_train,
         n_valid=n_valid, resident_bytes=int(train_arrays["image"].nbytes),
         data_load_s=data_s, launches=launches, loss_first8=first,
         loss_last8=last, valid=valid_recs, last_step={
             kk: last_rec[kk] for kk in ("loss", "recon", "kl", "elbo",
                                         "g_adv", "grad_norm", "d_loss",
                                         "d_acc", "beta")},
         resume_bit_exact=True, wall_s_first_24=wall_first,
         wall_s_resumed_24=wall_second, step_time_s=step_s,
         steps_per_s=1.0 / step_s,
         images_per_s=cfg.train.batch_size / step_s, **grads)
    return launches, state, cfg


def cifar_ckpt_phase(cfg, state, tmp: str, dev):
    """The final checkpoint restored into a fresh init_fn state scores the
    ELBO of the trained state in memory; then IWAE k=1000 on 64 test
    images. Returns the launches of the restored model's scorer and IWAE."""
    from apv_tpu_torch import (get_preset, load_dataset, make_scorer,
                               make_train_fns, restore_checkpoint)
    from apv_tpu_torch.eval.iwae_eval import estimate_log_partition
    from apv_tpu_torch.ops import kernels as K
    fresh = make_train_fns(cfg, device=dev).init_fn(cfg.train.seed)
    restore_checkpoint(Path(tmp) / cfg.name / "checkpoints", fresh)
    check(states_equal(fresh, state), "cifar_ckpt: the restored state "
          "differs from the trained one")
    images = load_dataset("cifar10", "test")[0][:BATCH]
    x = torch.from_numpy(images.astype(np.float32) / 255.0).to(dev)
    with torch.inference_mode():
        log_z = float(estimate_log_partition(fresh.d, cfg.model.z_dim,
                                             seed=SEED + 17, device=dev))
    mem = make_scorer(cfg, state.model, state.d, log_z, device=dev)
    elbo_mem = mem(x, generator=gen(SEED))
    scorer = make_scorer(cfg, fresh.model, fresh.d, log_z, device=dev)
    torch.cuda.synchronize()
    K.reset_launches()
    elbo = scorer(x, generator=gen(SEED))
    torch.cuda.synchronize()
    launches = path_counts(K)
    check(launches == expected(K, reparam=1, kl=1, disc_logistic=1),
          f"cifar_ckpt scorer launches {launches}")
    check(bool(torch.isfinite(elbo).all()) and torch.equal(elbo, elbo_mem),
          "cifar_ckpt: the restored model's ELBO differs from the trained "
          f"one's by {float((elbo - elbo_mem).abs().max())}")
    elbo_np = elbo.double().cpu().numpy()
    emit("cifar_ckpt_scorer", preset=cfg.name, batch=BATCH,
         launches=launches, elbo_mean=float(elbo_np.mean()),
         elbo_std=float(elbo_np.std()), log_partition=log_z,
         restored_equals_trained=True)
    iw = iwae_phase("cifar_ckpt", get_preset("iwae_eval"), fresh.model,
                    fresh.d, images, elbo_np, 25, dev)
    return {n: launches[n] + iw[n] for n in K.launches}


# ---------------------------------------------------------------------------
# phases 14-16: the trained priors and the IWAE objective, on the synthetic
# CIFAR set loaded once
# ---------------------------------------------------------------------------

def prior_config(preset: str, results_dir: str, steps: int, *extra: str):
    """``preset`` with its schedule cut to ``steps`` (the learning rate's
    warm-up and β's over the first half) and a checkpoint at the end, no
    validation (the set comes as arrays=)."""
    from apv_tpu_torch import apply_overrides, get_preset
    return apply_overrides(get_preset(preset), [
        f"results_dir={results_dir}", "train.log_every=1",
        f"train.steps={steps}", f"train.beta_warmup_steps={steps // 2}",
        "train.eval_every=0", f"train.checkpoint_every={steps}", *extra])


def checked_train(phase: str, cfg, arrays, dev, per_step: dict):
    """train_loop over ``arrays`` with the counters zeroed just around it:
    exact launches, one finite metrics line per step, and a falling loss
    (the mean over the last min(8, steps/2) steps below the first's).
    Returns (state, launches, records, wall_s, (first, last))."""
    from apv_tpu_torch import train_loop
    from apv_tpu_torch.ops import kernels as K
    steps = cfg.train.steps
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        state = train_loop(cfg, arrays=arrays, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_counts(K)
    check(launches == expected(K, **{n: steps * c
                                     for n, c in per_step.items()}),
          f"{phase} launches {launches}")
    records = read_metrics(cfg)
    check([r["step"] for r in records] == list(range(steps)),
          f"{phase}: one metrics line per step")
    check(all(math.isfinite(v) for r in records for v in r.values()),
          f"{phase}: a metric is not finite")
    loss = [r["loss"] for r in records]
    n = min(8, steps // 2)
    first, last = float(np.mean(loss[:n])), float(np.mean(loss[-n:]))
    check(last < first, f"{phase}: mean loss of the last {n} steps {last} "
          f"not below the first {n} {first}")
    return state, launches, records, wall, (first, last)


def check_flagship_width(phase: str, cfg) -> None:
    m, t = cfg.model, cfg.train
    check((m.z_dim, tuple(m.widths), m.blocks_per_stage, t.batch_size,
           t.steps_per_call, cfg.data.device_resident)
          == (128, (64, 128, 256), 2, 256, 8, True),
          f"{phase}: {cfg.name} is not the flagship's width, batch 256, "
          "resident data in calls of 8")


def sample_png(phase: str, preset: str, tmp: str, dev, **kw):
    """api.sample with the counters zeroed around it -> (images, launches,
    the JSON lines it printed, wall_s); 256 draws in [0, 1] whose PNG grid
    decodes to them."""
    from apv_tpu_torch import sample
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.sampling.run import image_grid
    from apv_tpu_torch.utils.png import decode_png
    torch.cuda.synchronize()
    K.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        images = sample(preset, overrides=[f"results_dir={tmp}"],
                        n=SAMPLE_N, seed=SEED, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_counts(K)
    check(tuple(images.shape) == (SAMPLE_N, 32, 32, 3)
          and bool(torch.isfinite(images).all())
          and float(images.min()) >= 0.0 and float(images.max()) <= 1.0,
          f"{phase}: images {tuple(images.shape)} not finite in [0, 1]")
    prior, temp = kw.get("prior", "auto"), kw.get("temperature", 1.0)
    suffix = ("" if prior == "auto" else f"_{prior}") + (
        "" if temp == 1.0 else f"_T{temp:g}")
    png = Path(tmp) / preset / f"samples{suffix}.png"
    check(np.array_equal(decode_png(png.read_bytes()), image_grid(images)),
          f"{phase}: {png.name} does not decode to the pixels written")
    lines = [json.loads(line) for line in out.getvalue().splitlines()
             if line.startswith("{")]
    return images, launches, lines, wall


def prior_phase(phase: str, preset: str, arrays, tmp: str, dev) -> dict:
    """cifar_gb (the trained Gaussian base under D) or cifar_flow (the
    trained flow) through train_loop, 24 steps; the step-24 checkpoint
    restored bit for bit, its scorer and IWAE k=1000 on 64 test images
    under its own prior (log Z from the learned base, or exactly 0);
    then api.sample from that prior. Returns (the launches of its paths,
    cfg)."""
    from apv_tpu_torch import (apply_overrides, load_dataset, make_scorer,
                               make_train_fns, restore_checkpoint)
    from apv_tpu_torch.eval.iwae_eval import estimate_log_partition
    from apv_tpu_torch.ops import kernels as K
    cfg = prior_config(preset, tmp, PRIOR_STEPS)
    gauss = cfg.model.prior == "gaussian"
    check_flagship_width(phase, cfg)
    check(cfg.model.prior in ("gaussian", "flow")
          and cfg.adversarial.enabled == gauss,
          f"{phase}: {preset} has prior {cfg.model.prior}, adversarial "
          f"{cfg.adversarial.enabled}")
    per_step = {"reparam": 1, "disc_logistic": 1, "reparam_bwd": 1,
                "disc_logistic_bwd": 1}
    state, launches, records, wall, (first, last) = checked_train(
        phase, cfg, arrays, dev, per_step)

    fresh = make_train_fns(cfg, device=dev).init_fn(cfg.train.seed)
    restore_checkpoint(Path(tmp) / cfg.name / "checkpoints", fresh)
    check(states_equal(fresh, state), f"{phase}: the restored state "
          "differs from the trained one")
    del state
    model, prior = fresh.model, fresh.model.prior
    with torch.no_grad():
        moved = float(prior.mu.abs().max() if gauss else max(
            layer["w3"].abs().max() for layer in prior.layers))
    check(moved > 0.0, f"{phase}: the prior never left its init")
    images = load_dataset("cifar10", "test")[0][:BATCH]
    x = torch.from_numpy(images.astype(np.float32) / 255.0).to(dev)
    d, log_z, log_z_std = (fresh.d if gauss else None), 0.0, None
    if gauss:
        with torch.inference_mode():
            log_z = float(estimate_log_partition(
                d, cfg.model.z_dim, seed=SEED + 17, device=dev,
                base_from=model.prior_sample_from))
            log_z_std = float(estimate_log_partition(
                d, cfg.model.z_dim, seed=SEED + 17, device=dev))
        check(log_z != log_z_std, f"{phase}: log Z under the learned base "
              "equals log Z under N(0, I)")
    scorer = make_scorer(cfg, model, d, log_z, device=dev)
    torch.cuda.synchronize()
    K.reset_launches()
    elbo = scorer(x, generator=gen(SEED))
    torch.cuda.synchronize()
    sc_launches = path_counts(K)
    check(sc_launches == expected(K, reparam=1, kl=1, disc_logistic=1),
          f"{phase} scorer launches {sc_launches}")
    check(bool(torch.isfinite(elbo).all()), f"{phase}: ELBO not finite")
    elbo_np = elbo.double().cpu().numpy()
    cfg_k = apply_overrides(cfg, ["eval.iwae_k=1000", "eval.iwae_chunk=25"])
    iw = iwae_phase(f"{phase}_iwae", cfg_k, model, d, images, elbo_np, 25,
                    dev, want_log_z=log_z)
    del fresh, model
    step_s = loop_step_s(prior_config(
        preset, tmp, TIMED_STEPS, f"name={cfg.name}_timed",
        "train.log_every=8"), arrays, dev)

    samples = {}
    total = {n: launches[n] + sc_launches[n] + iw[n] for n in K.launches}
    kinds = ([("T1", {}), ("T0.7", {"temperature": 0.7})] if gauss else
             [("T0.7", {"temperature": 0.7}),
              ("expost_flow", {"prior": "expost_flow",
                               "flow_steps": FLOW_FIT_STEPS})])
    for tag, kw in kinds:
        imgs, sl, lines, s_wall = sample_png(phase, preset, tmp, dev, **kw)
        want = expected(K, reparam=1) if tag == "expost_flow" \
            else expected(K)
        check(sl == want, f"{phase} sample {tag} launches {sl}")
        info = {"launches": sl, "wall_s": s_wall,
                "images_mean": float(imgs.mean()),
                "images_std": float(imgs.std())}
        for line in lines:
            info.update(line)
        if gauss:
            diag = info["sampler_diagnostics"]
            check(diag["sir_pool"] == SAMPLE_N * 16
                  and 1.0 <= diag["sir_ess"] <= SAMPLE_N * 16,
                  f"{phase}: SIR over the base {diag}")
        if tag == "expost_flow":
            check(math.isfinite(info["expost_flow_fit_nll"]),
                  f"{phase}: ex-post flow fit NLL not finite")
        samples[tag] = info
        total = {n: total[n] + sl[n] for n in K.launches}
    last_rec = records[-1]
    emit(phase, preset=preset, prior=cfg.model.prior, batch=256,
         steps=PRIOR_STEPS, launches=launches, loss_first8=first,
         loss_last8=last, last_step={k: v for k, v in last_rec.items()
                                     if k != "step"},
         wall_s_checked_run=wall, ms_per_step=step_s * 1e3,
         images_per_s=cfg.train.batch_size / step_s,
         prior_max_abs_move=moved, scorer_launches=sc_launches,
         elbo_mean=float(elbo_np.mean()), log_partition=log_z,
         log_partition_standard_base=log_z_std, samples=samples)
    return total, cfg


def iwae_plain_objective(cfg, model, d, x_in, x_target, key):
    """The IWAE-k objective at β = 1 written out with the kernels' plain
    versions (standard prior, learned_prior D inside log w, DReG): returns
    (-bound, -surrogate), each times the loss scale. The surrogate has the
    objective's gradient: θ reads recon at w̃ and φ reaches log w only
    through z (q's moments detached), at w̃²; a hook on the decoder's input
    lifts recon's z-path from w̃ to w̃². ``K.disc_logistic_plain`` expands x
    to the k·B rows."""
    from apv_tpu_torch.core.distributions import (gaussian_logpdf,
                                                  standard_gaussian_logpdf)
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.training.losses import \
        decoder_output_to_likelihood_params
    from apv_tpu_torch.training.step import _loss_scale
    k, b = cfg.train.iwae_k, x_in.shape[0]
    mean, logvar = model.encode(x_in)
    z = K.reparam_plain(mean, logvar, k, *key)                 # [k, B, Z]
    holder = {}
    z_dec = z.clone()
    z_dec.register_hook(lambda g: g * holder["w"][..., None])
    lik = decoder_output_to_likelihood_params(
        model.decode(z_dec.reshape(k * b, -1)), cfg.model.likelihood,
        x_target.shape[-1])
    recon = K.disc_logistic_plain(x_target, *lik).reshape(k, b)
    prior = (standard_gaussian_logpdf(z).sum(-1)
             - gaussian_logpdf(z, mean.detach(), logvar.detach()).sum(-1)
             + cfg.adversarial.weight * d(z.reshape(k * b, -1)).reshape(k, b))
    log_w = recon + prior
    holder["w"] = w = torch.softmax(log_w.detach(), dim=0)
    bound = (torch.logsumexp(log_w, dim=0) - math.log(k)).mean()
    surrogate = (w * recon + w.square() * prior).sum(0).mean()
    return -bound * _loss_scale(cfg), -surrogate * _loss_scale(cfg)


def iwae_grad_check(cfg, state, x_in, x_target, dev) -> dict:
    """One IWAE-objective G step's gradients through the kernels against
    ``iwae_plain_objective`` on the same Philox draws; f32 compute and
    deterministic cuDNN, as ``grad_check``. The two losses differ by no
    more than the likelihood's per-row bar in ``kernel_checks`` (the mean
    and the logsumexp over rows move by no more than their largest row)."""
    from apv_tpu_torch import build_model
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.training.step import g_objective_iwae
    torch.backends.cudnn.deterministic = True
    try:
        m32 = build_model(cfg.model, dtype=torch.float32, device=dev)
        m32.load_state_dict(state.model.state_dict())
        params = list(m32.parameters())
        loss_k, _, _ = g_objective_iwae(cfg, m32, state.d, x_in, x_target,
                                        1.0, generator=gen(SEED + 5))
        grads_k = torch.autograd.grad(loss_k, params)
        loss_p, surrogate = iwae_plain_objective(
            cfg, m32, state.d, x_in, x_target, K.draw_key(gen(SEED + 5)))
        grads_p = torch.autograd.grad(surrogate, params)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(grads_k, grads_p))
    check(rel <= 1e-3, f"iwae_train: G gradients kernels vs plain, "
          f"scale-relative {rel} > 1e-3")
    lk, lp = float(loss_k.detach()), float(loss_p.detach())
    tol = 1e-2 + 1e-5 * abs(lp)
    check(abs(lk - lp) <= tol, f"iwae_train: loss kernels {lk} vs plain "
          f"{lp}, |diff| > {tol}")
    return {"grad_max_scale_rel_err": rel, "loss_kernels": lk,
            "loss_plain": lp, "loss_tol": tol}


def iwae_train_phase(arrays, tmp: str, dev):
    """cifar_advprior_resnet with train.objective=iwae (k=5, DReG) through
    train_loop, 8 steps: the decoder at 1,280 rows, the likelihood beside
    x's 256, reparam's backward summing 5 samples; the peak of allocated
    memory; then one step's G gradients through the kernels held to the
    plain ops. Returns (launches, cfg)."""
    from apv_tpu_torch.data.preprocess import (normalize_center,
                                               uniform_dequantize)
    cfg = prior_config("cifar_advprior_resnet", tmp, IWAE_STEPS,
                       "name=cifar_iwae", "train.objective=iwae",
                       f"train.iwae_k={IWAE_K}", "train.iwae_grad=dreg")
    check_flagship_width("iwae_train", cfg)
    check(cfg.adversarial.enabled and cfg.adversarial.d_reuse_posterior
          and cfg.adversarial.variant == "learned_prior"
          and cfg.model.prior == "standard"
          and cfg.model.likelihood == "discretized_logistic",
          "iwae_train: expected the standard prior, D inside log w on the "
          "G phase's posterior, the discretized logistic")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_step = {"reparam": 1, "disc_logistic": 1, "reparam_bwd": 1,
                "disc_logistic_bwd": 1}
    state, launches, records, wall, (first, last) = checked_train(
        "iwae_train", cfg, arrays, dev, per_step)
    peak = torch.cuda.max_memory_allocated()
    image = torch.from_numpy(arrays["image"][:cfg.train.batch_size]).to(dev)
    u = torch.rand(image.shape, generator=torch.Generator(dev).manual_seed(
        SEED + 7), device=dev)
    x_in = normalize_center(uniform_dequantize(image, u=u))
    grads = iwae_grad_check(cfg, state, x_in,
                            image.to(torch.float32) / 255.0, dev)
    del state
    step_s = loop_step_s(prior_config(
        "cifar_advprior_resnet", tmp, TIMED_STEPS, "name=cifar_iwae_timed",
        "train.objective=iwae", f"train.iwae_k={IWAE_K}",
        "train.iwae_grad=dreg", "train.log_every=8"), arrays, dev)
    last_rec = records[-1]
    emit("iwae_train", preset="cifar_advprior_resnet", objective="iwae",
         iwae_k=IWAE_K, iwae_grad="dreg", batch=256, steps=IWAE_STEPS,
         decoder_rows=IWAE_K * 256, launches=launches, loss_first4=first,
         loss_last4=last, last_step={k: v for k, v in last_rec.items()
                                     if k != "step"},
         wall_s_checked_run=wall, ms_per_step=step_s * 1e3,
         images_per_s=cfg.train.batch_size / step_s,
         max_memory_allocated_bytes=peak,
         max_memory_allocated_gib=peak / 2 ** 30,
         card=torch.cuda.get_device_name(0), **grads)
    return launches, cfg


# ---------------------------------------------------------------------------
# phases 10-13: groupnorm_gelu, the conv probe, sample, ood
# ---------------------------------------------------------------------------

def groupnorm_phase(dev) -> dict:
    """The op's path: forward and backward through groupnorm_gelu's
    autograd.Function at the flagship shape (bf16, f32) and the odd shape
    (bf16, f32) with the counters zeroed around it, each direction on the
    image kernels at the first and the rows kernels at the second; values
    and gradients held to autograd of the plain version."""
    from apv_tpu_torch import groupnorm_gelu
    from apv_tpu_torch.ops import kernels as K
    rng = np.random.default_rng(SEED + 31)
    cases = [(shape, dtype) for shape in (GN_SHAPE, GN_ODD)
             for dtype in (torch.bfloat16, torch.float32)]
    inputs = [gn_inputs(rng, shape, dtype, dev) for shape, dtype in cases]
    torch.cuda.synchronize()
    K.reset_launches()
    outs = []
    for x, g, b, dy in inputs:
        xr, gr, br = (t.requires_grad_(True) for t in (x, g, b))
        y = groupnorm_gelu(xr, gr, br, 8)
        outs.append((y.detach(), torch.autograd.grad(y, (xr, gr, br), dy)))
    torch.cuda.synchronize()
    launches = path_counts(K)
    fwd_kernels = dict(K.groupnorm_gelu_routes)
    bwd_kernels = dict(K.groupnorm_gelu_bwd_routes)
    check(launches == expected(K, groupnorm_gelu=len(cases),
                               groupnorm_gelu_bwd=len(cases)),
          f"groupnorm_gelu launches {launches}")
    check(fwd_kernels == bwd_kernels == {"image": 2, "rows": 2},
          f"groupnorm_gelu kernels {fwd_kernels}, backward {bwd_kernels}: "
          f"expected the image kernels at {list(GN_SHAPE)} and the rows "
          f"kernels at {list(GN_ODD)}")
    errs = {}
    for (shape, dtype), (x, g, b, dy), (y, grads) in zip(cases, inputs,
                                                          outs):
        y_p = K.groupnorm_gelu_plain(x, g, b, 8)[0]
        ref = torch.autograd.grad(y_p, (x, g, b), dy)
        fwd = float((y.float() - y_p.detach().float()).abs().max()) / max(
            float(y_p.detach().float().abs().max()), 1.0)
        grad = max(scale_rel(a, c) for a, c in zip(grads, ref))
        tag = f"{list(shape)} {str(dtype).removeprefix('torch.')}"
        errs[tag] = {"fwd": fwd, "grad_scale_rel": grad}
        check(fwd <= GN_FWD_TOL[dtype], f"groupnorm_gelu {tag}: forward "
              f"{fwd} > {GN_FWD_TOL[dtype]}")
        check(grad <= GN_GRAD_TOL[dtype], f"groupnorm_gelu {tag}: gradients "
              f"{grad} > {GN_GRAD_TOL[dtype]}")
        check(all(bool(torch.isfinite(t).all()) for t in (y, *grads)),
              f"groupnorm_gelu {tag}: not finite")
    x, g, b, dy = (t.detach() for t in inputs[0])
    xr, gr, br = (t.requires_grad_(True) for t in (x, g, b))
    fwd_bwd = cuda_ms(lambda: torch.autograd.grad(
        groupnorm_gelu(xr, gr, br, 8), (xr, gr, br), dy), 100)
    emit("groupnorm_gelu", launches=launches, fwd_kernels=fwd_kernels,
         bwd_kernels=bwd_kernels,
         errs=errs,
         tol_fwd="1e-5 (f32), 2^-7 (bf16) x max(max|y|, 1)",
         tol_grad="scale-relative 1e-4 (f32), 1e-2 (bf16)",
         fwd_bwd_ms_bf16=fwd_bwd)
    return launches


PROBE_BENCH = {"n_iter": 10, "windows": 2, "reps": 2}


def conv_phase(dev) -> dict:
    """The probe's path: ``conv_probe.run`` at its three shapes, bf16 and
    f32, with the counters zeroed around it; the kernel's error against
    f32 F.conv2d per record."""
    from apv_tpu_torch.ops import conv_probe
    from apv_tpu_torch.ops import kernels as K
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    records = conv_probe.run(device=dev, seed=SEED, **PROBE_BENCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_counts(K)
    per_run = 1 + PROBE_BENCH["n_iter"] * (
        1 + PROBE_BENCH["windows"] * PROBE_BENCH["reps"])
    check(launches == expected(K, conv3x3=per_run * 2 * len(
        conv_probe.SHAPES)), f"conv3x3 launches {launches}")
    check(K.conv3x3_routes == {"wgmma": launches["conv3x3"], "simt": 0},
          f"conv3x3 probe launches by kernel {K.conv3x3_routes}: all on "
          "the tensor cores expected")
    for r in records:
        if r["impl"] == "conv3x3":
            tol = 1e-5 if r["dtype"] == "float32" else 1e-2
            check(r["rel_err_vs_f32"] <= tol, f"conv probe {r}: error > "
                  f"{tol}")
    emit("conv3x3", launches=launches, records=records, wall_s=wall,
         bench=PROBE_BENCH)
    return launches


SAMPLE_N, SAMPLE_REFINE, QUALITY_N, GMM_K = 256, 20, 512, 10


def sample_phase(tmp: str, dev) -> dict:
    """api.sample on the step-48 checkpoint: SIR + MALA draws, the PNG
    grid read back, sample quality; then the ex-post GMM prior."""
    from apv_tpu_torch import sample
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.sampling.run import image_grid
    from apv_tpu_torch.utils.png import decode_png
    over = [f"results_dir={tmp}"]
    torch.cuda.synchronize()
    K.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        images = sample("cifar_advprior_resnet", overrides=over, n=SAMPLE_N,
                        refine=SAMPLE_REFINE, quality_n=QUALITY_N, seed=SEED,
                        device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_counts(K)
    check(launches == expected(K), f"sample launches {launches} (SIR, MALA, "
          "decoding and the feature net launch no port kernel)")
    diag = next(json.loads(line)["sampler_diagnostics"]
                for line in out.getvalue().splitlines()
                if line.startswith('{"sampler_diagnostics"'))
    check(tuple(images.shape) == (SAMPLE_N, 32, 32, 3)
          and bool(torch.isfinite(images).all())
          and float(images.min()) >= 0.0 and float(images.max()) <= 1.0,
          f"sample: images {tuple(images.shape)} not finite in [0, 1]")
    pool = SAMPLE_N * 16
    check(diag["sir_pool"] == pool and 1.0 <= diag["sir_ess"] <= pool,
          f"sample: SIR pool {diag['sir_pool']}, ESS {diag['sir_ess']}")
    check(0.0 < diag["mala_accept_rate"] <= 1.0
          and diag["mala_steps"] == SAMPLE_REFINE,
          f"sample: MALA acceptance {diag['mala_accept_rate']}")
    run_dir = Path(tmp) / "cifar_advprior_resnet"
    t1 = time.perf_counter()
    pixels = decode_png((run_dir / "samples.png").read_bytes())
    decode_s = time.perf_counter() - t1
    check(np.array_equal(pixels, image_grid(images)),
          "sample: the PNG grid does not decode to the pixels written")
    quality = json.loads((run_dir / "sample_quality.json").read_text())
    check(quality["n"] == QUALITY_N and quality["pixel_mode"] == "sample"
          and all(math.isfinite(quality[k]) for k in (
              "frechet_rfd", "mmd2_rbf", "density", "coverage")),
          f"sample_quality: {quality}")

    K.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        gmm_images = sample("cifar_advprior_resnet", overrides=over,
                            n=SAMPLE_N, prior="expost_gmm", gmm_k=GMM_K,
                            seed=SEED, device=dev)
    torch.cuda.synchronize()
    wall_gmm = time.perf_counter() - t0
    gmm_launches = path_counts(K)
    check(gmm_launches == expected(K, reparam=1),
          f"sample expost_gmm launches {gmm_launches} (one reparam: the "
          "posterior draws of the fit)")
    check(bool(torch.isfinite(gmm_images).all())
          and float(gmm_images.min()) >= 0.0
          and float(gmm_images.max()) <= 1.0
          and (run_dir / "samples_expost_gmm.png").exists(),
          "sample expost_gmm: images not finite in [0, 1] or no grid")
    emit("sample", preset="cifar_advprior_resnet", n=SAMPLE_N,
         refine_steps=SAMPLE_REFINE, diagnostics=diag, quality=quality,
         launches=launches, wall_s=wall, png_bytes=(
             run_dir / "samples.png").stat().st_size, png_decode_s=decode_s,
         images_mean=float(images.mean()), expost_gmm_k=GMM_K,
         expost_gmm_launches=gmm_launches, expost_gmm_wall_s=wall_gmm,
         expost_gmm_images_mean=float(gmm_images.mean()))
    return {n: launches[n] + gmm_launches[n] for n in K.launches}


# (in, ood, score, k, chunk, max_examples, batch) as the preset sets them
OOD_PRESET = ("cifar10", "svhn", "prior_ratio", 100, 50, 2000, 64)


def ood_phase(tmp: str, dev) -> dict:
    """api.ood_score on ood_suite as the preset sets it, both directions
    (each direction timed), then score=complexity; exact launches: each
    scored dataset is 31 batches of 64 at k=100 in chunks of 50, once
    under the shaped prior and once under N(0, I) for prior_ratio."""
    import apv_tpu_torch.eval.ood as ood_mod
    from apv_tpu_torch import get_preset, ood_score
    from apv_tpu_torch.ops import kernels as K
    cfg = get_preset("ood_suite")
    o = cfg.ood
    check((o.in_dataset, o.ood_dataset, o.score, o.iwae_k, o.iwae_chunk,
           o.max_examples, o.batch_size) == OOD_PRESET,
          f"ood_suite preset: {o}")
    over = [f"results_dir={tmp}"]
    n_rows = (o.max_examples // o.batch_size) * o.batch_size
    per_call = (o.max_examples // o.batch_size) * (o.iwae_k // o.iwae_chunk)
    direction_s = []
    scores_fn = ood_mod.ood_scores

    def timed_scores(*a, **k):
        t = time.perf_counter()
        r = scores_fn(*a, **k)
        torch.cuda.synchronize()
        direction_s.append(time.perf_counter() - t)
        return r

    torch.cuda.synchronize()
    K.reset_launches()
    ood_mod.ood_scores = timed_scores
    try:
        t0 = time.perf_counter()
        res = ood_score("ood_suite", overrides=over, both=True, seed=SEED,
                        device=dev)
        wall = time.perf_counter() - t0
    finally:
        ood_mod.ood_scores = scores_fn
    launches = path_counts(K)
    n_calls = 2 * 2 * 2             # directions x datasets x (p*, N(0, I))
    check(launches == expected(K, reparam=n_calls * per_call,
                               disc_logistic=n_calls * per_call),
          f"ood launches {launches}")
    check(json.loads((Path(tmp) / "ood_suite" / "ood.json").read_text())
          == json.loads(json.dumps(res)), "ood: ood.json differs")

    def sane(r):
        return (all(0.0 <= r[k] <= 1.0 for k in (
            "auroc_in_vs_ood", "auroc_ood_vs_in", "fpr_at_95_tpr"))
            and math.isfinite(r["in_mean"]) and math.isfinite(r["ood_mean"])
            and r["n_in"] == r["n_ood"] == n_rows)

    check(sane(res["forward"]) and sane(res["reverse"])
          and res["reverse_model"] == "shared", f"ood: {res}")

    K.reset_launches()
    t0 = time.perf_counter()
    cres = ood_score("ood_suite", overrides=over + ["ood.score=complexity"],
                     seed=SEED, device=dev)
    wall_c = time.perf_counter() - t0
    c_launches = path_counts(K)
    check(c_launches == expected(K, reparam=2 * per_call,
                                 disc_logistic=2 * per_call),
          f"ood complexity launches {c_launches}")
    check(sane(cres), f"ood complexity: {cres}")
    scored = [2 * (r["n_in"] + r["n_ood"])
              for r in (res["forward"], res["reverse"])]
    emit("ood", preset="ood_suite", k=o.iwae_k, chunk=o.iwae_chunk,
         batch=o.batch_size, max_examples=o.max_examples, result=res,
         launches=launches, wall_s=wall, direction_wall_s=direction_s,
         images_per_s=[n / s for n, s in zip(scored, direction_s)],
         complexity=cres, complexity_launches=c_launches,
         complexity_wall_s=wall_c)
    return {n: launches[n] + c_launches[n] for n in K.launches}


def quality_gate(dev, tmp: str) -> None:
    """The reference's short CIFAR gate (scripts/act_gates.sh): 3,000 steps
    of cifar_advprior_resnet on the synthetic set, validation every 1,000,
    then IWAE k=100 (chunk 25, batch 64) of the final checkpoint on the
    first 512 test images; bits/dim, active units and wall time."""
    from apv_tpu_torch import (apply_overrides, evaluate_nll, get_preset,
                               load_dataset, make_train_fns,
                               restore_checkpoint, train_loop)
    from apv_tpu_torch.core.metrics import active_units
    from apv_tpu_torch.eval.run import _prep_eval_batch
    cfg = apply_overrides(get_preset("cifar_advprior_resnet"), [
        f"results_dir={tmp}", "name=cifar_gate", f"train.steps={GATE_STEPS}",
        f"train.eval_every={GATE_STEPS // 3}",
        f"train.checkpoint_every={GATE_STEPS}",
        "train.log_every=100"])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train_loop(cfg, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    records = read_metrics(cfg)
    check(all(math.isfinite(v) for r in records for v in r.values()),
          "quality_gate: a metric is not finite")
    cfg4 = apply_overrides(get_preset("iwae_eval"),
                           ["eval.iwae_k=100", "eval.max_examples=512"])
    state = make_train_fns(cfg, device=dev).init_fn(cfg.train.seed)
    restore_checkpoint(Path(tmp) / cfg.name / "checkpoints", state)
    images = load_dataset("cifar10", "test")[0][:cfg4.eval.max_examples]
    t0 = time.perf_counter()
    res = evaluate_nll(cfg4, state.model, state.d, images,
                       k=cfg4.eval.iwae_k, chunk=cfg4.eval.iwae_chunk,
                       batch_size=cfg4.eval.batch_size, seed=SEED, device=dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    with torch.inference_mode():
        means = [state.model.encode(torch.from_numpy(_prep_eval_batch(
            cfg4, images[i:i + 64])[0]).to(dev))[0].cpu().numpy()
            for i in range(0, len(images), 64)]
    n_active, _ = active_units(means)
    check(math.isfinite(res["bits_per_dim"]) and math.isfinite(
        res["nll_nats"]), "quality_gate: bits/dim not finite")
    emit("quality_gate", preset=cfg.name, steps=cfg.train.steps,
         iwae_k=cfg4.eval.iwae_k, chunk=cfg4.eval.iwae_chunk,
         examples=res["num_examples"], bits_per_dim=res["bits_per_dim"],
         nll_nats=res["nll_nats"], nll_nats_se=res["nll_nats_se"],
         log_partition=res["log_partition"],
         active_units=n_active, z_dim=cfg.model.z_dim,
         valid=[r for r in records if "valid_elbo" in r],
         last_train=[r for r in records if "loss" in r][-1],
         train_wall_s=train_s, eval_wall_s=eval_s)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="also profile one IWAE batch of each family, 16 "
                         "train steps of each family, of both trained "
                         "priors and of the IWAE objective; write tables "
                         "here")
    ap.add_argument("--quality-gate", action="store_true",
                    help="also run the 3k-step CIFAR gate and IWAE k=100 "
                         "on 512 test images (a few minutes)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import apv_tpu_torch
    check(Path(apv_tpu_torch.__file__).resolve().parent
          == ROOT / "apv_tpu_torch",
          "apv_tpu_torch must come from this checkout")
    from apv_tpu_torch import (build_model, get_preset, make_latent_d)
    from apv_tpu_torch.data.preprocess import static_binarize
    from apv_tpu_torch.ops import _build
    from apv_tpu_torch.ops import kernels as K

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device and build
    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.library()
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device_count=torch.cuda.device_count(),
         build_s=_build.build_seconds,
         load_s=time.perf_counter() - t0)

    # 2. kernels
    with torch.inference_mode():
        kres = kernel_checks(K, card, dev)
    krng = np.random.default_rng(SEED + 30)
    kres.update(gn_kernel_checks(K, card, krng, dev))
    kres.update(conv_kernel_checks(K, card, krng, dev))
    for name, r in kres.items():
        emit("kernel", name=name, **{"library_ms": None, **r})

    # 3-4. scorer and IWAE of the CIFAR flagship at full width
    count_shapes(K)
    cfg = get_preset("cifar_advprior_resnet")
    model = build_model(cfg.model, device=dev, seed=SEED)
    d = make_latent_d(cfg.adversarial, cfg.model.z_dim, device=dev,
                      seed=SEED + 1)
    images = np.random.default_rng(SEED + 2).integers(
        0, 256, size=(BATCH, 32, 32, 3), dtype=np.uint8)
    x = torch.from_numpy(images.astype(np.float32) / 255.0).to(dev)
    path_launches = {}
    path_launches["scorer"], elbo_np = scorer_phase("scorer", cfg, model, d,
                                                    x, dev)
    cfg4 = get_preset("iwae_eval")
    path_launches["iwae"] = iwae_phase("iwae", cfg4, model, d, images,
                                       elbo_np, 25, dev)
    if args.profile is not None:
        profile_window(args.profile, "iwae", lambda: evaluate_iwae(
            cfg4, model, d, images, dev))
    del model, d

    # 5. training mnist_advprior at full width
    with tempfile.TemporaryDirectory() as tmp:
        path_launches["train"], state, cfg2 = train_phase(dev, tmp)
        if args.profile is not None:
            profile_train(args.profile, cfg2, dev)

    # 6-7. scorer and IWAE on the trained weights
    bits = static_binarize(synthetic_digits(BATCH, SEED + 4),
                           seed=cfg2.train.seed + 1)
    xb = torch.from_numpy(bits.astype(np.float32)).to(dev)
    path_launches["mnist_scorer"], elbo_np = scorer_phase(
        "mnist_scorer", cfg2, state.model, state.d, xb, dev)
    path_launches["mnist_iwae"] = iwae_phase(
        "mnist_iwae", cfg2, state.model, state.d, bits, elbo_np, 50, dev)
    if args.profile is not None:
        profile_window(args.profile, "mnist_iwae", lambda: evaluate_iwae(
            cfg2, state.model, state.d, bits, dev))
    del state

    # 8-9. training cifar_advprior_resnet, then its checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        path_launches["cifar_train"], state, cfg3 = cifar_train_phase(dev,
                                                                      tmp)
        path_launches["cifar_ckpt"] = cifar_ckpt_phase(cfg3, state, tmp, dev)
        del state
        # 10-13. the fused op, the conv probe, then config 5 on the
        # step-48 checkpoint
        path_launches["groupnorm_gelu"] = groupnorm_phase(dev)
        path_launches["conv3x3"] = conv_phase(dev)
        path_launches["sample"] = sample_phase(tmp, dev)
        path_launches["ood"] = ood_phase(tmp, dev)
        if args.profile is not None:
            profile_new_paths(args.profile, tmp, dev)
        if args.profile is not None:
            profile_train(args.profile, cfg3, dev, tag="cifar_train")
        if args.quality_gate:
            quality_gate(dev, tmp)

    # 14-16. the trained priors and the IWAE objective at full width, on
    # the synthetic CIFAR set loaded once for the three
    with tempfile.TemporaryDirectory() as tmp:
        from apv_tpu_torch.training.loop import load_train_arrays
        t0 = time.perf_counter()
        arrays, _ = load_train_arrays(prior_config("cifar_gb", tmp,
                                                   PRIOR_STEPS))
        emit("cifar_arrays", rows=len(arrays["image"]),
             load_s=time.perf_counter() - t0)
        path_launches["gb_train"], cfg_gb = prior_phase(
            "gb_train", "cifar_gb", arrays, tmp, dev)
        path_launches["flow_train"], cfg_flow = prior_phase(
            "flow_train", "cifar_flow", arrays, tmp, dev)
        path_launches["iwae_train"], cfg5 = iwae_train_phase(arrays, tmp,
                                                             dev)
        if args.profile is not None:
            profile_train(args.profile, cfg_gb, dev, tag="gb_train")
            profile_train(args.profile, cfg_flow, dev, tag="flow_train")
            profile_train(args.profile, cfg5, dev, tag="iwae_train")

    total = {n: sum(pl[n] for pl in path_launches.values())
             for n in K.launches}
    for name, n in total.items():
        check(n > 0, f"{name} was not launched on the main paths")
    emit("launch_shapes", shapes=[
        {"name": name, "rows": r, "x_rows": b, "event": e, "launches": n}
        for (name, (r, b, e)), n in sorted(PATH_SHAPES.items())])
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": total[name],
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"],
         "bound_ms": kres[name]["bound_ms"],
         "bound_by": kres[name]["bound_by"],
         "library_ms": kres[name].get("library_ms")}
        for name in REPLACES]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# --profile: device time by kernel and the device's idle share
# ---------------------------------------------------------------------------

def evaluate_iwae(cfg, model, d, images, dev):
    from apv_tpu_torch import evaluate_nll
    evaluate_nll(cfg, model, d, images, k=cfg.eval.iwae_k,
                 chunk=cfg.eval.iwae_chunk, batch_size=len(images),
                 seed=SEED + 2, device=dev)


def profile_train(out_dir: Path, cfg, dev, steps: int = 16,
                  tag: str = "train") -> None:
    """16 steady train steps of ``cfg`` on resident data (packed digits, or
    uint8 CIFAR-shaped levels for the dequantized configs), as the loop
    runs them (without its logger), after 8 warm-up steps."""
    from apv_tpu_torch.data.preprocess import pack_bits, static_binarize
    from apv_tpu_torch.training.step import make_train_fns
    fns = make_train_fns(cfg, device=dev)
    state = fns.init_fn(cfg.train.seed)
    if cfg.data.dequantize:
        key, rows = "image", np.random.default_rng(SEED + 6).integers(
            0, 256, size=(4096, *cfg.model.image_shape), dtype=np.uint8)
    else:
        key, rows = "image_packed", pack_bits(static_binarize(
            synthetic_digits(4096, SEED + 6)))
    data = torch.from_numpy(rows).to(dev)
    idx = torch.randint(0, len(rows), (steps + 8, cfg.train.batch_size),
                        generator=gen(SEED)).to(dev)

    def run(lo, hi):
        for i in range(lo, hi):
            fns.train_step(state, {key: data.index_select(0, idx[i])})
        torch.cuda.synchronize()

    run(0, 8)
    profile_window(out_dir, tag, lambda: run(8, 8 + steps), steps=steps)


def profile_new_paths(out_dir: Path, tmp: str, dev) -> None:
    """Device time of the fused op (10 forward+backward passes, bf16
    [256, 32, 32, 64]), of reparam (100 calls at each of its three path
    shapes, each beside a one-element kernel, the launch floor), of the
    conv kernel (40 calls at each probe shape
    and dtype, a window each: the profiler drops the kernels of a
    window's first ~0.5 ms) and of one OOD IWAE pass (4 batches of 64 at k=100, chunk
    50, the shaped prior) on the step-48 checkpoint."""
    from apv_tpu_torch import evaluate_nll, groupnorm_gelu
    from apv_tpu_torch.api import (_adopt_checkpoint_arch, _resolve,
                                   _restore_state)
    from apv_tpu_torch.eval.run import eval_arrays
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.ops.conv_probe import SHAPES
    rng = np.random.default_rng(SEED + 40)
    x, g, b, dy = gn_inputs(rng, GN_SHAPE, torch.bfloat16, dev)
    xr, gr, br = (t.requires_grad_(True) for t in (x, g, b))

    def gn_passes():
        for _ in range(10):
            torch.autograd.grad(groupnorm_gelu(xr, gr, br, 8), (xr, gr, br),
                                dy)

    gn_passes()
    profile_window(out_dir, "groupnorm_gelu", gn_passes)
    # reparam at the IWAE and OOD chunks and the CIFAR train step, each
    # launch beside a one-element neg_: the launch floor (floor_us)
    one = torch.zeros(1, device=dev)
    for s_, shape in ((25, (64, 128)), (50, (64, 128)), (1, (256, 128))):
        m = torch.randn(shape, device=dev)
        lv = torch.rand(shape, device=dev) - 2.0

        def reparam_calls():
            for i in range(100):
                K.reparam_cuda(m, lv, s_, SEED, i)
                one.neg_()

        reparam_calls()
        profile_window(out_dir, f"reparam_{s_}x{shape[0]}x{shape[1]}",
                       reparam_calls, with_floor=True)
    for bb, h, w, cin, cout in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            xc = torch.randn((bb, h, w, cin), device=dev).to(dtype)
            wc = (0.05 * torch.randn((3, 3, cin, cout), device=dev)).to(dtype)

            def conv_calls():
                with torch.inference_mode():
                    for _ in range(40):
                        K.conv3x3_cuda(xc, wc)

            conv_calls()
            profile_window(out_dir, f"conv3x3_{str(dtype)[6:]}_"
                           f"{bb}x{h}x{w}x{cin}x{cout}", conv_calls)
            del xc, wc
    over = [f"results_dir={tmp}"]
    cfg = _adopt_checkpoint_arch(_resolve("ood_suite", over), over)
    state = _restore_state(cfg, device=dev)
    images = eval_arrays(cfg, "cifar10", max_examples=256)["image"]
    profile_window(out_dir, "ood_pass", lambda: evaluate_nll(
        cfg, state.model, state.d, images, k=cfg.ood.iwae_k,
        chunk=cfg.ood.iwae_chunk, batch_size=cfg.ood.batch_size, seed=SEED,
        use_adversarial_prior=True, device=dev))


def profile_window(out_dir: Path, tag: str, fn, with_floor: bool = False,
                   **extra) -> None:
    """Device time by kernel over ``fn()`` (torch.profiler), its wall time
    and the device's idle share; with ``with_floor``, also the device time
    a launch of the one-element ``neg_`` that ``fn`` interleaves with its
    kernels (``floor_us``)."""
    from torch.profiler import ProfilerActivity, profile
    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=60)
    (out_dir / f"{tag}_profile.txt").write_text(table)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # Device-side records only (kernels, memsets, copies): the aten ops
    # above them repeat their kernels' time, and "Command Buffer Full" is
    # the host waiting for room in the launch queue.
    events = [e for e in prof.key_averages()
              if "CUDA" in str(e.device_type) and dev_us(e) > 0
              and e.key != "Command Buffer Full"]
    total_us = sum(dev_us(e) for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:16]
    ours = {}
    for name, fns in KERNEL_FNS.items():
        mine = [e for e in events for fn in fns
                if f"::{fn}(" in e.key or f"::{fn}<" in e.key]
        if mine:
            calls = sum(e.count for e in mine)
            ours[name] = {"device_us_per_call": sum(map(dev_us, mine))
                          / calls, "calls": calls,
                          "functions": [e.key[:120] for e in mine]}
    # with with_floor: fn also launches a one-element neg_ (and no other neg)
    floor = [e for e in events if with_floor and "neg" in e.key]
    floor_us = (sum(map(dev_us, floor)) / sum(e.count for e in floor)
                if floor else None)
    emit("profile", window=tag, wall_s=wall, device_busy_s=total_us / 1e6,
         device_idle_share=max(0.0, 1.0 - total_us / 1e6 / wall),
         top=[{"name": e.key[:80], "device_ms": dev_us(e) / 1e3,
               "calls": e.count} for e in top], kernels=ours,
         floor_us=floor_us, **extra)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
