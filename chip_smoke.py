#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py                      # needs one CUDA card
    python3 chip_smoke.py --profile DIR        # also writes profiler tables
    python3 chip_smoke.py --quality-gate       # also the 3k-step CIFAR gate
    python3 chip_smoke.py --biadv-seeds 24     # phase 18's gradient check at
                                               # 24 seeds, nothing else
    python3 chip_smoke.py --prior-kl-only [--parent-csrc DIR]
                                               # phase 24 alone
    python3 chip_smoke.py --graph-step-only    # phase 25 alone

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
     the OOD chunk and the train step; reparam with its KL blocks and its
     backward with and without the KL's row gradient at the ELBO's
     posterior shapes and an odd one, with whether their bits equal the
     unfused kernels' and their times beside the unfused kernels'
     (kl_bwd, which no main path launches, is held there too);
     bernoulli_bwd also at
     257 rows and with dx; groupnorm_gelu and its backward
     also at shapes that take their other kernels, each twice for the
     same bits, each held to the kernel that ran;
     conv3x3 also at two odd shapes, one for each of its routes (tensor
     cores, SIMT), each held to the kernel that ran, and on views off
     TMA's alignment; rmsnorm_act and its backward at the ResNet's three
     stage widths at the IWAE chunk's and the train step's rows, bf16 and
     f32, each activation at an odd row count (vector kernels) and an odd
     width (scalar), and off 16-byte alignment (scalar), each twice for
     the same bits, with each direction's call and device time at the six
     stage shapes beside the plain chain's and F.rms_norm + F.silu's.
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
     autograd of the plain version and to the kernels that must run;
     then rmsnorm_act: the ResNet's fused norm modules at the train
     step's three stage shapes, forward and backward, one launch each
     way a module on the vector kernels, held to autograd of the plain
     chain.
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
 17. front_door: the port's CLI, each command a child process running
     apv_tpu_torch.cli as `python -m` does (the launch counts read back
     from the child): `train` of cifar_advprior_resnet at full width for 16
     steps with --trace-dir (the Chrome trace of steps 10-15 must hold
     the kernels), `train --resume --max-steps 8` (to step 24), `evaluate
     --preset iwae_eval --checkpoint-dir ...` at k=1000 on 64 test images
     under --prior model and --prior expost (finite bits/dim, active
     units, eval.json and eval_expost.json), then `info`, `info <name>`
     and `presets` in one child with no visible CUDA device (CUDA left
     uninitialized), beside a child running `train` of mnist_advprior
     for 16 steps (the bernoulli pair through the CLI); exact launches per
     command. The CLI runs' synthetic sets are cut to 4,096 images a split
     (data.synthetic_size) to keep the wall short.
 18. biadv_train: cifar_advprior_resnet with adversarial.variant=
     biadversarial, r1_gamma=1 and d_spectral_norm=true through train_loop
     on the arrays of phases 14-16, 24 steps; exact launches, finite
     d_loss/px_d_loss/d_r1/px_d_r1/g_px, a falling loss, ms a step as in
     14, peak memory; the checkpoint restored bit for bit; one G step's
     gradients through the kernels held to the step written out with
     their plain versions (f32, the pixel D in f32), the D step's inputs
     (z_q, x̂) to the plain path's and its gradients to the D loss
     written out, and the D gradients across the two paths' inputs, on
     the rows where both give the Ds the same activation masks (the
     flipped units counted), to a bar set by a witness of D's own
     sensitivity (biadv_grad_check); then
     api.ood_score with ood.score=pixel_d (both directions, 2,000
     examples) and api.sample (256 SIR draws through the SN latent D).
 19. knobs_train: the flagship with adversarial.d_lr_schedule=
     floor_adaptive, train.ema_decay=0.999 and train.grad_accum=2 through
     train_loop on the arrays of 14-16, 24 micro-steps in calls of 1,
     cuDNN's deterministic algorithms on; exact launches, factors in
     [0, 1], a falling loss; the same run cut at micro-step 13 (inside a
     window) and resumed to 24 equals it bit for bit, shadow and
     accumulators included; api.evaluate (iwae_eval,
     k=1000, 64 images) on its checkpoint scores the shadow: its bits/dim
     equal evaluate_nll of the shadow's weights and differ from the raw
     parameters'; the synchronizing calls torch.cuda.set_sync_debug_mode(
     "warn") reports over 8 steps, the flagship's and the knobs' (the
     knobs may add none); ms a step as in 14 beside phase 8's.
 20. mix_train: the flagship with model.likelihood=disc_logistic_mix
     (K=5, a 45-channel head), 24 steps; exact launches (no likelihood
     kernel: the mixture is plain torch on every device, as in apv_tpu);
     one G step's gradients through the kernels held to the plain ops;
     IWAE k=1000 on 64 images, finite; api.sample in both pixel modes,
     each PNG read back; ms a step beside phase 8's, and the mixture
     op's forward and backward alone (CUDA events; with --profile, its
     share of a step's device time).
 21. visualize: api.visualize with reconstruct, interpolate and latent
     (SIR + 20 MALA steps) on knobs_train's EMA checkpoint, beside one
     `apv-torch sample --visualize latent` child (started as phase 20
     begins); each PNG decodes to its shape and is not constant;
     reconstruct equals the shadow's own reconstruction of the same
     draw.
 22. export: api.export_artifact of the scorer on knobs_train's EMA
     checkpoint (a torch.export program traced on the card, its reparam,
     kl and disc_logistic custom ops launching the kernels), called at
     batch 64, 16 and 1, each call's launches counted and its ELBO held
     to make_scorer of the restored shadow with the same Philox key at
     1e-5 of the ELBO's scale, and to the plain ops (plain reparam, kl
     and likelihood, no kernel) at scorer_phase's bar; the sampler
     artifact of that shadow (SIR + 20 MALA steps in the graph):
     deterministic in the seed, in [0, 1]; an int8 sampler at the CLI's
     2 MALA steps, held to the CLI's f32 one: the file under half of it,
     mean |Δ| under 0.05, in [0, 1]; a full-width mnist_advprior scorer
     artifact from seeded weights for the bernoulli kernel, held as the
     CIFAR one; beside one child running `apv-torch export` for the
     scorer and the sampler (its scorer scores as the phase's) and a
     tempered scorer, which it must refuse, started with phase 21's
     child as phase 20 begins. The export (trace, save) and load
     seconds, ms an artifact call against the in-process call, and
     whether tensorstore imports here.
 23. distributed: data parallelism over torch.distributed on the one
     card, its children started before phase 14 and collected after 22:
     (a) `apv-torch train --distributed` of the flagship at full width as
     a world of one over NCCL (APV_COORDINATOR=127.0.0.1:<free port>,
     APV_NUM_PROCESSES=1, APV_PROCESS_ID=0), 8 steps under cuDNN's
     deterministic algorithms, its checkpoint equal bit for bit to the
     same 8 steps without a group in this process; (b) two ranks sharing
     the card over gloo, 128 rows each of the global batch of 256, 8
     steps through train_loop: the replicas equal bit for bit, the
     losses finite, each rank's launches; (c) on those ranks the
     k-sharded IWAE (eval.k_shards=2: k=1000 in two shards of 20 chunks
     of 25, 64 images) equal to this process's evaluate_nll of rank 0's
     checkpoint with the same seed within rtol 1e-5. ms a step from the
     runs' loggers (calls of one step, each logged). The synthetic sets
     are cut to 4,096 images a split.
     NCCL refuses two ranks on one card: no run here has two cards.
 24. prior_kl: the reparam kernel's learned-prior variant (VDVAE's
     layers) at the vdvae cell's shapes, z [128, 16, r, r] for r = 1, 4,
     8, 16 and 32, reading q and p [128, 32, r, r] in place, each way
     against its plain version (z, the per-image KL; dq and dp given z's
     gradient and the KL's, each alone and both): one launch each way,
     counted under reparam and reparam_bwd, each with its device time
     from the profiler and its share of the bytes' least time. With
     --parent-csrc DIR (another checkout's ops/csrc) the N(0, I)
     instances (apv_reparam with and without its KL blocks at the train
     step's S = 1 and the IWAE objective's S = 5, apv_reparam_bwd with and
     without the KL term) give that build's bits.
 25. graph_step: the train step captured in a CUDA graph and replayed
     (training/graph.py) against the eager step, for the flagship (from
     step 10, inside β's and the learning rate's warm-ups) and VDVAE, at
     their cells' full sizes: GRAPH_K + 1 steps from one state each way
     under deterministic cuDNN (the runner's first step is eager, the
     rest replays), whose state, host counts, metrics and launch and
     route counts must be equal bit for bit; then GRAPH_TIMED steps each
     way timed (steps a second), the peak of device memory each way and
     the capture's wall.
Each path runs once with the launch counters zeroed just before it and
read just after; the ResNet's fused norm must launch its forward kernel
once a call of its module on the card and its backward once a call whose
output receives a gradient (count_norms; in the CLI children too), and
the scorer and IWAE phases hold its forward launches to 13 a ResNet
encoder or decoder forward; a kernel of the paths that did not launch
fails the run
(OFF_PATH lists the one kernel that no path launches, and a launch of it
fails the run too). Under the standard prior the ELBO's z and KL come
from one reparam launch and go back through one reparam_bwd launch.
The likelihood forwards' launches on the paths by (rows, x rows, E) are a
"launch_shapes" line (counted by this script's shims over the two
wrappers).
With --quality-gate, the reference's short gate follows: 3,000 steps of
cifar_advprior_resnet on the synthetic set, then IWAE k=100 on 512 test
images to bits/dim, with the active units and the wall time.
Every phase line carries t_s, the seconds since the script started.
Then a {"kernels": [...]} line, the nvidia-smi line and, last, the
{"ok": true, ...} line. Any failed check exits nonzero without that line.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()
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
# products and sums of the rule, the dx affine). rmsnorm_act two for the
# statistics, two to normalize, the rounding and ~6 for SiLU (an exp, an
# add, a division); rmsnorm_act_bwd ~20 (the norm again, SiLU's
# derivative, the rule's products and sums, dw's sum).
OPS_PER_ELEM = {"disc_logistic": 30, "reparam": 33, "kl": 6, "bernoulli": 7,
                "bernoulli_bwd": 5, "kl_bwd": 5, "reparam_bwd": 5,
                "disc_logistic_bwd": 30, "groupnorm_gelu": 13,
                "groupnorm_gelu_bwd": 25, "rmsnorm_act": 11,
                "rmsnorm_act_bwd": 20}

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
    # no TPU kernel: XLA fused nn.RMSNorm and the activation after it
    "rmsnorm_act": "none: XLA's fusion of apv_tpu/models/resnet_vae.py:38",
    "rmsnorm_act_bwd": "none: XLA's fusion of its gradient",
}
# Kernels that no main path launches: kl_bwd, the backward of kl alone,
# serves the callers that differentiate ops.kl_standard by itself; the
# ELBO's KL term goes back through reparam_bwd's launch. Phase 2 holds it
# to its plain version; a main-path launch of it fails the run.
OFF_PATH = ("kl_bwd",)
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
              "conv3x3": ("conv3x3_wgmma", "conv3x3_simt"),
              "rmsnorm_act": ("rmsnorm_act_rows", "rmsnorm_act_rows_scalar"),
              "rmsnorm_act_bwd": ("rmsnorm_act_bwd_rows",
                                  "rmsnorm_act_bwd_rows_scalar")}
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
FRONT_STEPS = (16, 8)      # the CLI's train, then its resume
FRONT_SYNTHETIC = 4_096    # the CLI runs' synthetic images a split
BIADV_STEPS = 24           # the biadversarial flagship: three calls of 8
DIST_STEPS = 8              # phase 23's runs: one call of 8
DIST_SYNTHETIC = 4_096      # their synthetic sets, a split
DIST_K = (1000, 25, 2)      # the k-sharded IWAE: k, chunk, k-shards
DIST_EXTRA: tuple = ()      # overrides of phase 23's runs (none on the card)
DIST_SETS = ("train.steps_per_call=1", "train.log_every=1",
             f"data.synthetic_size={DIST_SYNTHETIC}")
BIADV = ("adversarial.variant=biadversarial", "adversarial.r1_gamma=1.0",
         "adversarial.d_spectral_norm=true")
# A CIFAR train step's launches: reparam and its backward, the
# likelihood's pair. Under the standard prior the reparam launch also sums
# the KL and its backward takes the KL's term (no kl, no kl_bwd launch);
# the trained priors' KL and the IWAE objective use no KL kernel.
PER_CIFAR_STEP = {"reparam": 1, "disc_logistic": 1, "reparam_bwd": 1,
                  "disc_logistic_bwd": 1}


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - T0}), flush=True)


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


def bound(name: str, card: str, nbytes: int, elems: int,
          ops: float | None = None) -> dict:
    """The larger of the bytes' time and the operations' (``ops``, or
    OPS_PER_ELEM[name] an element of ``elems``)."""
    t_bytes = nbytes / mem_bw(card)
    t_ops = (OPS_PER_ELEM[name] * elems if ops is None else ops) / F32_OPS
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
            at[tag]["plain_ms"] = cuda_ms(
                lambda: K.disc_logistic_plain(xc, mc, sc), 20)
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
            "plain_ms": cuda_ms(lambda: K.reparam_plain(mi, li, s_, seed,
                                                        offset), 20),
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
    fwd, bwd = posterior_kernel_checks(K, card, cuda)
    results["reparam"]["with_kl"] = fwd
    results["reparam_bwd"]["with_kl"] = bwd
    return results


# [S, B, Z] of the ELBO's posterior op: the CIFAR and MNIST train steps, the
# scorer's batch, the IWAE objective's S = 5, and an odd shape (the scalar
# loads and stores, a KL block holding one row of its two)
POSTERIOR_SHAPES = ((1, 256, 128), (1, 256, 40), (1, 64, 128),
                    (5, 256, 128), (1, 7, 13))
POSTERIOR_TIMED = ((1, 256, 128), (5, 256, 128))


def posterior_kernel_checks(K, card: str, cuda) -> tuple[dict, dict]:
    """The reparam kernel with its KL blocks (``reparam_kl_cuda``) and its
    backward with the KL's row gradient (``reparam_bwd_cuda(g_kl=)``) and
    without, at POSTERIOR_SHAPES: z within reparam's bar (1e-5 of 1 + |z|),
    the KL within kl's (1e-4 + 1e-6·max |kl|), the gradients within
    reparam_bwd's and kl_bwd's (1e-6 of 1 + |ref|) of their plain
    versions; and whether the bits equal the unfused kernels' (reparam +
    kl; reparam_bwd + kl_bwd + the add autograd made of them), which the
    design expects. Times at POSTERIOR_TIMED, beside the unfused
    kernels'. Returns (forward, backward) fields by shape."""
    rng = np.random.default_rng(SEED + 39)
    seed, offset = 0x0123456789ABCDEF, 42
    fwd, bwd = {}, {}
    for s_, b_, z_ in POSTERIOR_SHAPES:
        tag, n = f"{s_}x{b_}x{z_}", b_ * z_
        m = cuda(rng.normal(size=(b_, z_)).astype(np.float32))
        lv = cuda(rng.uniform(-4.0, 1.0, size=(b_, z_)).astype(np.float32))
        z, kl = K.reparam_kl_cuda(m, lv, s_, seed, offset)
        zp, klp = K.reparam_kl_plain(m, lv, s_, seed, offset)
        z_rel, kl_err = ulp_err(z, zp), float((kl - klp).abs().max())
        kl_tol = 1e-4 + 1e-6 * float(klp.abs().max())
        check(z_rel <= 1e-5 and kl_err <= kl_tol, f"reparam with kl {tag}: "
              f"z {z_rel} (bar 1e-5), kl {kl_err} (bar {kl_tol})")
        again = K.reparam_kl_cuda(m, lv, s_, seed, offset)
        check(torch.equal(z, again[0]) and torch.equal(kl, again[1]),
              f"reparam with kl {tag}: a second call gave other bits")
        fwd[tag] = {
            "shape": [s_, b_, z_], "max_rel_err_z": z_rel,
            "max_abs_err_kl": kl_err, "tol_kl": kl_tol,
            "equal_bits_to_unfused": torch.equal(
                z, K.reparam_cuda(m, lv, s_, seed, offset))
            and torch.equal(kl, K.kl_cuda(m, lv)),
            # mean and logvar read once, z and kl written once
            **bound("reparam", card, 4 * (2 * n + s_ * n + b_), s_ * n,
                    ops=OPS_PER_ELEM["reparam"] * s_ * n
                    + OPS_PER_ELEM["kl"] * n)}
        g = cuda(rng.normal(size=(s_, b_, z_)).astype(np.float32))
        g_kl = cuda(rng.normal(size=b_).astype(np.float32))
        with_kl = K.reparam_bwd_cuda(g, z, m, g_kl=g_kl, logvar=lv)
        without = K.reparam_bwd_cuda(g, z, m)
        err_kl = max(ulp_err(a, b) for a, b in zip(
            with_kl, K.reparam_bwd_plain(g, z, m, g_kl, lv)))
        err_no = max(ulp_err(a, b) for a, b in zip(
            without, K.reparam_bwd_plain(g, z, m)))
        check(max(err_kl, err_no) <= 1e-6, f"reparam_bwd {tag}: max rel "
              f"err {err_kl} with the KL's gradient, {err_no} without")
        parts = K.kl_bwd_cuda(g_kl, m, lv)
        bwd[tag] = {
            "shape": [s_, b_, z_], "max_rel_err": err_kl,
            "max_rel_err_without_kl": err_no,
            "equal_bits_to_unfused": all(
                torch.equal(a, b + c) for a, b, c in zip(with_kl, without,
                                                         parts)),
            # g and z read once, mean, logvar and g_kl once, two outputs
            **bound("reparam_bwd", card, 4 * (2 * s_ * n + 2 * n + b_
                                              + 2 * n), s_ * n,
                    ops=OPS_PER_ELEM["reparam_bwd"] * s_ * n
                    + (OPS_PER_ELEM["kl_bwd"] + 2) * n)}
        if (s_, b_, z_) not in POSTERIOR_TIMED:
            continue

        def unfused_bwd():
            a, b = K.reparam_bwd_cuda(g, z, m), K.kl_bwd_cuda(g_kl, m, lv)
            return a[0] + b[0], a[1] + b[1]

        fwd[tag].update(
            ms=cuda_ms(lambda: K.reparam_kl_cuda(m, lv, s_, seed, offset),
                       500),
            unfused_ms=cuda_ms(lambda: (K.reparam_cuda(m, lv, s_, seed,
                                                       offset),
                                        K.kl_cuda(m, lv)), 500),
            plain_ms=cuda_ms(lambda: K.reparam_kl_plain(m, lv, s_, seed,
                                                        offset), 50))
        bwd[tag].update(
            ms=cuda_ms(lambda: K.reparam_bwd_cuda(g, z, m, g_kl=g_kl,
                                                  logvar=lv), 500),
            ms_without_kl=cuda_ms(lambda: K.reparam_bwd_cuda(g, z, m), 500),
            unfused_ms=cuda_ms(unfused_bwd, 500),
            plain_ms=cuda_ms(lambda: K.reparam_bwd_plain(g, z, m, g_kl, lv),
                             50))
    return fwd, bwd


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
            at[tag]["plain_ms"] = cuda_ms(
                lambda: K.bernoulli_plain(x, logits), 50)
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
        "plain_ms": cuda_ms(lambda: K.reparam_bwd_plain(gi, zi, mi), 50),
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
        "plain_ms": cuda_ms(lambda: K.disc_logistic_bwd_plain(
            gi, xi, mi, si), 20),
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


# (path, rows, C): the ResNet's three stage widths at the IWAE chunk (1,600
# rows a chunk) and the train step (batch 256), one pixel a row
RMS_SHAPES = (("iwae", 1600 * 1024, 64), ("iwae", 1600 * 256, 128),
              ("iwae", 1600 * 64, 256), ("train", 256 * 1024, 64),
              ("train", 256 * 256, 128), ("train", 256 * 64, 256))
# (rows, C, the kernel that must run) for every activation: the vector
# path off a whole block of rows, the scalar variant at an odd width
RMS_ODD = ((4099, 64, "vector"), (37, 24, "scalar"))
# forward: f32 scale-relative; bf16 in ulps (rms_fwd_err); gradients
# scale-relative
RMS_FWD_TOL = {torch.float32: 1e-6, torch.bfloat16: 1.0}
RMS_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def rms_inputs(rng, rows, c, dtype, dev):
    x = torch.from_numpy((rng.normal(size=(rows, c)) * 2.0 + 0.3).astype(
        np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.normal(size=c) * 0.5 + 1.0).astype(
        np.float32)).to(dev)
    dy = torch.from_numpy(rng.normal(size=(rows, c)).astype(np.float32)).to(
        dev, dtype)
    return x, w, dy


def bf16_neighbours(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 values next to each of ``n``'s, below and above."""
    n = torch.where(n == 0, torch.zeros_like(n), n)          # -0 as +0
    b = n.view(torch.int16).to(torch.int32)
    up = torch.where(n >= 0, b + 1, b - 1)
    dn = torch.where(n > 0, b - 1, torch.where(n == 0, -32767, b + 1))
    return tuple(t.to(torch.int16).view(torch.bfloat16) for t in (dn, up))


def rms_fwd_err(K, x, w, act, y) -> tuple[float, float]:
    """(error, share of elements equal to the plain chain's) of the
    kernel's y. f32: scale-relative. bf16: the worst element's distance,
    in bf16 ulps of the chain's value, from the nearest of the chain's y
    at n and at n's two bf16 neighbours (the norm n rounded to bf16; a
    channel sum taken in another order can move n across a rounding)."""
    want = K.rmsnorm_act_plain(x, w, act)
    same = float((y == want).float().mean())
    if x.dtype == torch.float32:
        return scale_rel(y, want), same
    x32 = x.float()
    n = (x32 * (torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-6)
                * w)).to(torch.bfloat16)
    yf, best = y.float(), None
    for cand in (n, *bf16_neighbours(n)):
        c = K.ACTIVATIONS[act](cand).float()
        ulp = torch.exp2(torch.floor(torch.log2(
            c.abs().clamp_min(2.0 ** -126))) - 7)
        d = (yf - c).abs() / ulp
        best = d if best is None else torch.minimum(best, d)
    return float(best.max()), same


def device_us(fn, functions, calls: int = 20) -> float:
    """Device µs a call of ``fn`` in the kernels named ``functions``
    (torch.profiler over ``calls`` calls after one more)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls + 1):
            fn()
        torch.cuda.synchronize()
    tot, n = 0.0, 0
    for e in prof.key_averages():
        if any(f"::{f}(" in e.key or f"::{f}<" in e.key for f in functions):
            tot += getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0))
            n = max(n, e.count)
    return tot / n if n else float("nan")


def library_rms_silu(x, w):
    """F.rms_norm + F.silu on NHWC rows, w in x's dtype: the library's
    version of the op (timed only)."""
    return F.silu(F.rms_norm(x, (x.shape[-1],), w.to(x.dtype), 1e-6))


def rms_kernel_checks(K, card: str, rng, dev) -> dict:
    """rmsnorm_act and rmsnorm_act_bwd against their plain versions at
    RMS_SHAPES in bf16 and f32 (SiLU, the flagship's) and at RMS_ODD with
    every activation, each called twice for the same bits and held to
    the kernel that must run (vector or scalar), and off 16-byte
    alignment (scalar); then, at RMS_SHAPES in bf16, each direction's
    call time, device time, bound, the plain version's time and the
    library's F.rms_norm + F.silu (forward; backward on a retained
    graph). The IWAE shapes' forward writes no rstd, as inference runs."""
    errs = {}

    def check_case(tag, x, w, dy, act, kernel):
        K.reset_launches()
        with torch.inference_mode():
            yk, rk = K.rmsnorm_act_cuda(x, w, act, want_rstd=True)
            y2, r2 = K.rmsnorm_act_cuda(x, w, act, want_rstd=True)
            fwd, same = rms_fwd_err(K, x, w, act, yk)
            stats = scale_rel(rk, K.rms_rstd(x))
            ek = K.rmsnorm_act_bwd_cuda(dy, x, w, rk, act)
            again = K.rmsnorm_act_bwd_cuda(dy, x, w, rk, act)
            ep = K.rmsnorm_act_bwd_plain(dy, x, w, rk, act)
        bwd = [scale_rel(a, c) for a, c in zip(ek, ep)]
        errs[tag] = {"fwd": fwd, "fwd_equal_share": same, "rstd": stats,
                     "dx": bwd[0], "dw": bwd[1]}
        check(fwd <= RMS_FWD_TOL[x.dtype] and stats <= 1e-6,
              f"rmsnorm_act {tag}: forward {fwd}, rstd {stats}")
        check(max(bwd) <= RMS_GRAD_TOL[x.dtype],
              f"rmsnorm_act_bwd {tag}: dx, dw scale-relative {bwd}")
        check(torch.equal(yk, y2) and torch.equal(rk, r2),
              f"rmsnorm_act {tag}: a second call gave other bits")
        check(all(torch.equal(a, c) for a, c in zip(ek, again)),
              f"rmsnorm_act_bwd {tag}: a second call gave other bits")
        for key, name, routes in (
                ("fwd_kernel", "rmsnorm_act", K.rmsnorm_act_routes),
                ("bwd_kernel", "rmsnorm_act_bwd", K.rmsnorm_act_bwd_routes)):
            ran = errs[tag][key] = dict(routes)
            check(ran == {**dict.fromkeys(K.RMS_KERNELS, 0), kernel: 2},
                  f"{name} {tag}: launched {ran}, expected the {kernel} "
                  "kernel twice")

    for path, rows, c in RMS_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x, w, dy = rms_inputs(rng, rows, c, dtype, dev)
            check_case(f"{path} [{rows},{c}] "
                       f"{str(dtype).removeprefix('torch.')}",
                       x, w, dy, "silu", "vector")
            del x, dy
    for rows, c, kernel in RMS_ODD:
        for act in K.RMS_ACTIVATIONS:
            for dtype in (torch.bfloat16, torch.float32):
                x, w, dy = rms_inputs(rng, rows, c, dtype, dev)
                check_case(f"[{rows},{c}] {act} "
                           f"{str(dtype).removeprefix('torch.')}",
                           x, w, dy, act, kernel)
    # views one element off 16-byte alignment take the scalar variant
    x, w, dy = rms_inputs(rng, 4099, 64, torch.bfloat16, dev)
    xs, dys = (torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:]
               .view(t.shape).copy_(t) for t in (x, dy))
    check_case("[4099,64] silu bfloat16 off 16-byte alignment", xs, w, dys,
               "silu", "scalar")

    fwd_fns = ("rmsnorm_act_rows",)
    bwd_fns = ("rmsnorm_act_bwd_rows", "rmsnorm_act_param_sum")
    rows_out = []
    for path, rows, c in RMS_SHAPES:
        x, w, dy = rms_inputs(rng, rows, c, torch.bfloat16, dev)
        rstd_out = path == "train"
        n = rows * c
        with torch.inference_mode():
            _, rk = K.rmsnorm_act_cuda(x, w, "silu", want_rstd=True)

            def fwd():
                return K.rmsnorm_act_cuda(x, w, "silu", want_rstd=rstd_out)

            def bwd():
                return K.rmsnorm_act_bwd_cuda(dy, x, w, rk, "silu")
            r = {"path": path, "rows": rows, "c": c, "dtype": "bfloat16",
                 "fwd_ms": cuda_ms(fwd, 100),
                 "fwd_device_us": device_us(fwd, fwd_fns),
                 "fwd_plain_ms": cuda_ms(
                     lambda: K.rmsnorm_act_plain(x, w, "silu"), 10),
                 "fwd_library_ms": cuda_ms(
                     lambda: library_rms_silu(x, w), 100),
                 "bwd_ms": cuda_ms(bwd, 100),
                 "bwd_device_us": device_us(bwd, bwd_fns),
                 "bwd_plain_ms": cuda_ms(lambda: K.rmsnorm_act_bwd_plain(
                     dy, x, w, rk, "silu"), 10)}
        xr, wr = (t.detach().requires_grad_(True) for t in (x, w))
        y_lib = library_rms_silu(xr, wr)
        r["bwd_library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            y_lib, (xr, wr), dy, retain_graph=True), 50)
        del y_lib
        fb = bound("rmsnorm_act", card,
                   2 * 2 * n + 4 * c + (4 * rows if rstd_out else 0), n)
        bb = bound("rmsnorm_act_bwd", card, 3 * 2 * n + 4 * rows + 8 * c, n)
        r.update(fwd_bound_ms=fb["bound_ms"], fwd_bound_by=fb["bound_by"],
                 bwd_bound_ms=bb["bound_ms"], bwd_bound_by=bb["bound_by"])
        rows_out.append(r)
        del x, dy, rk
    first = rows_out[0]
    tag0 = f"iwae [{first['rows']},{first['c']}] bfloat16"
    return {
        "rmsnorm_act": {
            "shape": [first["rows"], first["c"]], "dtype": "bfloat16",
            "max_abs_err": errs[tag0]["fwd"], "errs": errs,
            "tol_fwd": "1e-6 scale-relative (f32); 1 bf16 ulp from the "
                       "chain at n or a bf16 neighbour of n (bf16)",
            "ms": first["fwd_ms"], "plain_ms": first["fwd_plain_ms"],
            "library_ms": first["fwd_library_ms"],
            "library": "F.rms_norm + F.silu, forward",
            "bound_ms": first["fwd_bound_ms"],
            "bound_by": first["fwd_bound_by"], "by_shape": rows_out},
        "rmsnorm_act_bwd": {
            "shape": [first["rows"], first["c"]], "dtype": "bfloat16",
            "max_abs_err": errs[tag0]["dx"],
            "tol": "scale-relative 1e-5 (f32), 1e-2 (bf16)",
            "ms": first["bwd_ms"], "plain_ms": first["bwd_plain_ms"],
            "library_ms": first["bwd_library_ms"],
            "library": "backward of F.rms_norm + F.silu on a retained graph",
            "bound_ms": first["bwd_bound_ms"],
            "bound_by": first["bwd_bound_by"]},
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
    K.COUNTERS.append(SHAPES_NOW)          # a replayed step's launches too
    K.bernoulli_cuda = shim("bernoulli", K.bernoulli_cuda)
    K.disc_logistic_cuda = shim("disc_logistic", K.disc_logistic_cuda)


# The ResNet's fused norm (models/common.py::RMSNormAct): one rmsnorm_act
# launch a call of the module on a CUDA tensor, one rmsnorm_act_bwd launch
# a call whose output receives a gradient. A shim over the module's
# forward counts those calls into NORMS_NOW (cleared with the launch
# counts); each path's launches of the two kernels must equal them, and
# are then left out of the path's counts (zeroed), so the other kernels'
# expectations stand as they were. NORM_TOTAL sums the checked launches.
NORM_KERNELS = ("rmsnorm_act", "rmsnorm_act_bwd")
NORMS_NOW: collections.Counter = collections.Counter()
NORM_TOTAL: collections.Counter = collections.Counter()


def count_norms(K) -> None:
    """From here on (once a process), count the fused norm's module calls
    into NORMS_NOW, which ``K.reset_launches`` clears with the counts."""
    from apv_tpu_torch.models.common import RMSNormAct
    from apv_tpu_torch.utils.logging import _traced
    if getattr(RMSNormAct.forward, "counted", False):
        return
    real, reset = RMSNormAct.forward, K.reset_launches

    def received(grad):
        NORMS_NOW["rmsnorm_act_bwd"] += 1

    def forward(self, x):
        y = real(self, x)
        if y.device.type == torch.device(DEVICE).type and not _traced():
            NORMS_NOW["rmsnorm_act"] += 1
            if y.requires_grad:
                y.register_hook(received)
        return y

    def reset_all():
        reset()
        NORMS_NOW.clear()

    forward.counted = True
    RMSNormAct.forward = forward
    K.reset_launches = reset_all
    K.COUNTERS.append(NORMS_NOW)           # a replayed step's calls too


def norm_checked(launches: dict, calls, where: str) -> dict:
    """``launches`` with the fused norm's two kernels checked against the
    module ``calls`` of the same path (``NORMS_NOW``'s form), added to
    NORM_TOTAL and zeroed."""
    got = {n: launches.get(n, 0) for n in NORM_KERNELS}
    want = {n: calls.get(n, 0) for n in NORM_KERNELS}
    check(got == want, f"{where}: the fused norm launched {got} for "
          f"{want} module calls on the card")
    NORM_TOTAL.update(got)
    return {**launches, **dict.fromkeys(NORM_KERNELS, 0)}


def path_counts(K, norm_calls: dict | None = None) -> dict:
    """The launch counts of the path just run (zeroed just before it), its
    likelihood launches by shape added to PATH_SHAPES, its fused norm's
    checked against the module calls (``norm_calls`` where the path runs
    the norm outside the modules: an exported artifact)."""
    PATH_SHAPES.update(SHAPES_NOW)
    return norm_checked(dict(K.launches),
                        NORMS_NOW if norm_calls is None else norm_calls,
                        "path")


def norms_a_forward(net) -> int:
    """The fused norms one forward of ``net`` calls."""
    from apv_tpu_torch.models.common import RMSNormAct
    return sum(isinstance(m, RMSNormAct) for m in net.modules())


def expected(K, **counts) -> dict:
    """A full launch-count dict: the named kernels at their counts, the
    rest at 0."""
    return {name: counts.get(name, 0) for name in K.launches}


def norm_structure(K, phase: str, cfg, model, encodes: int,
                   decodes: int) -> dict:
    """The fused norm's forward launches of the path just run, against
    the model's structure: one a norm of each encoder and decoder forward,
    13 each for a norm=rms ResNet at the flagship's depth (three stages of
    two blocks, two norms a block, and the trunk's last), none for the
    other families."""
    enc = norms_a_forward(model.encoder)
    dec = norms_a_forward(model.decoder)
    rms = cfg.model.family == "resnet" and cfg.model.norm == "rms"
    check((enc, dec) == ((13, 13) if rms else (0, 0)),
          f"{phase}: {enc} fused norms in the encoder, {dec} in the decoder")
    want = encodes * enc + decodes * dec
    got = K.launches["rmsnorm_act"]
    check(got == want, f"{phase}: rmsnorm_act launched {got} times, the "
          f"model's structure gives {want} ({encodes} encoder and "
          f"{decodes} decoder forwards)")
    return {"encoder_norms": enc, "decoder_norms": dec, "launches": got}


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def plain_elbo(cfg, model, d, x, log_z, seed, *, plain_z: bool = False):
    """The scorer's ELBO with the plain ops, on the kernel path's z (drawn
    with ``gen(seed)``), or with ``plain_z`` on the plain reparam's z of
    the Philox key (seed, 0), as a scorer artifact keys it: no kernel."""
    from apv_tpu_torch import ops
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.training.losses import \
        decoder_output_to_likelihood_params
    with torch.inference_mode():
        x_in = x if cfg.data.binarize else x * 2.0 - 1.0
        mean, logvar = model.encode(x_in)
        z = (K.reparam_plain(mean, logvar, 1, seed, 0)[0] if plain_z
             else ops.reparam_sample(mean, logvar, generator=gen(seed)))
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
    norms = norm_structure(K, phase, cfg, model, 1, 1)
    launches = path_counts(K)
    recon = "bernoulli" if cfg.model.likelihood == "bernoulli" \
        else "disc_logistic"
    check(launches == expected(K, reparam=1, **{recon: 1}),
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
         norm_launches=norms,
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
    norms = norm_structure(K, phase, cfg, model, 1, k // chunk)
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
         launches=launches, norm_launches=norms, **res,
         elbo_mean=float(elbo_np.mean()),
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


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block: two runs of the
    same steps then give the same bits (the default backward algorithms
    may sum in another order from run to run)."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def grad_check(cfg, state, x_in, x_target, dev, phase="train") -> dict:
    """One G step's gradients through the kernels against the same step
    through the plain ops, on the same noise: the plain Philox stream
    reproduces the kernel's ε. f32 compute and deterministic cuDNN, so the
    two differ only by the kernels' rounding (in bf16 a z one ulp apart
    can round to another bf16 value and move every later layer)."""
    from apv_tpu_torch import build_model, ops
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.training.losses import (
        decoder_output_to_likelihood_params, loss_scale)
    from apv_tpu_torch.training.step import g_objective
    with deterministic_cudnn():
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
        if cfg.model.likelihood == "bernoulli":
            recon = K.bernoulli_plain(x_target, *lik)
        elif cfg.model.likelihood == "disc_logistic_mix":
            recon = ops.disc_logistic_mix_recon_ll(x_target, *lik)
        else:
            recon = K.disc_logistic_plain(x_target, *lik)
        adv = cfg.adversarial.weight * beta * state.d(z)
        loss_p = -((recon + adv).mean() - beta * K.kl_plain(
            mean, logvar).mean()) * loss_scale(cfg)
        grads_p = torch.autograd.grad(loss_p, params)
        torch.cuda.synchronize()
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
    per_step = {"reparam": 1, "bernoulli": 1, "reparam_bwd": 1,
                "bernoulli_bwd": 1}
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
    """Bit equality of two TrainStates: step, seed, parameters, buffers,
    both optimizers' counts and moments, and where a state has them the
    EMA shadow and the accumulators' running means and micro-steps."""
    def flat(st):
        sd = st.state_dict()
        out = [sd["step"], sd["seed"], sorted(sd)]
        tensors = [*sd["model"].values(),
                   *sd.get("ema_model", {}).values()]
        for o in ("opt", "d_opt"):
            if o in sd:
                out += [sd[o]["count"], sd[o].get("mini_step")]
                tensors += [*sd[o]["mu"], *sd[o]["nu"],
                            *sd[o].get("acc", [])]
        if "d" in sd:
            tensors += [*sd["d"].values()]
        return out, tensors
    (ha, ta), (hb, tb) = flat(a), flat(b)
    return ha == hb and len(ta) == len(tb) and all(
        x.dtype == y.dtype and torch.equal(x, y.to(x.device))
        for x, y in zip(ta, tb))


def cifar_train_phase(dev, tmp: str):
    """Returns (launches of the checked runs, trained state, cfg, s a step
    of the timed run)."""
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
    per_valid = {"reparam": 1, "disc_logistic": 1}
    want = {n: CIFAR_STEPS * PER_CIFAR_STEP.get(n, 0)
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
    return launches, state, cfg, step_s


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
    check(launches == expected(K, reparam=1, disc_logistic=1),
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


def check_flagship_width(phase: str, cfg, steps_per_call: int = 8) -> None:
    m, t = cfg.model, cfg.train
    check((m.z_dim, tuple(m.widths), m.blocks_per_stage, t.batch_size,
           t.steps_per_call, cfg.data.device_resident)
          == (128, (64, 128, 256), 2, 256, steps_per_call, True),
          f"{phase}: {cfg.name} is not the flagship's width, batch 256, "
          f"resident data in calls of {steps_per_call}")


def sample_png(phase: str, preset: str, tmp: str, dev, name=None, **kw):
    """api.sample with the counters zeroed around it -> (images, launches,
    the JSON lines it printed, wall_s); 256 draws in [0, 1] whose PNG grid
    decodes to them. ``name``: the run to sample (default the preset's)."""
    from apv_tpu_torch import sample
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.sampling.run import image_grid
    from apv_tpu_torch.utils.png import decode_png
    torch.cuda.synchronize()
    K.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        images = sample(preset, overrides=[f"results_dir={tmp}"] + (
            [] if name is None else [f"name={name}"]), n=SAMPLE_N, seed=SEED,
                        device=dev, **kw)
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
    png = Path(tmp) / (name or preset) / f"samples{suffix}.png"
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
    state, launches, records, wall, (first, last) = checked_train(
        phase, cfg, arrays, dev, PER_CIFAR_STEP)

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
    check(sc_launches == expected(K, reparam=1, disc_logistic=1),
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
    from apv_tpu_torch.training.losses import (
        decoder_output_to_likelihood_params, loss_scale)
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
    return -bound * loss_scale(cfg), -surrogate * loss_scale(cfg)


def iwae_grad_check(cfg, state, x_in, x_target, dev) -> dict:
    """One IWAE-objective G step's gradients through the kernels against
    ``iwae_plain_objective`` on the same Philox draws; f32 compute and
    deterministic cuDNN, as ``grad_check``. The two losses differ by no
    more than the likelihood's per-row bar in ``kernel_checks`` (the mean
    and the logsumexp over rows move by no more than their largest row)."""
    from apv_tpu_torch import build_model
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.training.step import g_objective_iwae
    with deterministic_cudnn():
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
# phases 17-18: the CLI, then the biadversarial flagship
# ---------------------------------------------------------------------------

# A child running apv_tpu_torch.cli as `python -m` does, its launch counts
# (zeroed at its start) and its fused norm's module calls (count_norms)
# written to the file named by APV_LAUNCHES_OUT.
CLI_CHILD = """\
import json, os, runpy
import chip_smoke
from apv_tpu_torch.ops import kernels as K
chip_smoke.count_norms(K)
K.reset_launches()
try:
    runpy.run_module("apv_tpu_torch.cli", run_name="__main__", alter_sys=True)
finally:
    with open(os.environ["APV_LAUNCHES_OUT"], "w") as f:
        json.dump({"launches": dict(K.launches),
                   "norm_calls": dict(chip_smoke.NORMS_NOW)}, f)
"""


# CLI_CHILD with TF32 off and cuDNN's deterministic algorithms, as this
# script runs the comparison (phase 23 (a)).
DIST_CHILD = """\
import json, os, runpy
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
import chip_smoke
from apv_tpu_torch.ops import kernels as K
chip_smoke.count_norms(K)
K.reset_launches()
try:
    runpy.run_module("apv_tpu_torch.cli", run_name="__main__", alter_sys=True)
finally:
    with open(os.environ["APV_LAUNCHES_OUT"], "w") as f:
        json.dump({"launches": dict(K.launches),
                   "norm_calls": dict(chip_smoke.NORMS_NOW)}, f)
"""


# A child running the CLI's main() on each argv of the JSON list in argv[1]
# in turn, each command's output closed by a NO_CUDA_END line; last, whether
# CUDA was initialized.
NO_CUDA_CHILD = """\
import json, sys
import torch
from apv_tpu_torch.cli import main
for argv in json.loads(sys.argv[1]):
    code = main(argv)
    print("\\n" + json.dumps({"no_cuda_end": argv, "code": code}),
          flush=True)
    if code:
        sys.exit(code)
print(json.dumps({"cuda_initialized": torch.cuda.is_initialized()}))
"""


def start_cli(args: list[str], tmp: str, *, tag: str,
              child: str = CLI_CHILD, no_cuda: bool = False,
              env_add: dict | None = None) -> dict:
    """Start ``child`` (CLI_CHILD: the CLI, with its launch counts) with
    ``args`` in a process from this checkout, its output into files under
    ``tmp`` named by ``tag``; ``no_cuda`` hides every CUDA device from
    it; ``env_add`` adds to its environment."""
    env = dict(os.environ, **(env_add or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    if no_cuda:
        env["CUDA_VISIBLE_DEVICES"] = ""
    count = child in (CLI_CHILD, DIST_CHILD)
    counts = Path(tmp) / f"launches_{tag}.json"
    env["APV_LAUNCHES_OUT"] = str(counts)
    cmd = [sys.executable, "-c", child, *args]
    out, err = Path(tmp) / f"{tag}.out", Path(tmp) / f"{tag}.err"
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=fo,
                                stderr=fe, text=True)
    return {"proc": proc, "args": args, "counts": counts if count else None,
            "out": out, "err": err, "t0": time.perf_counter()}


def finish_cli(h: dict, timeout: int = 600):
    """Wait for a child of ``start_cli`` -> (stdout, its launch counts or
    None, wall_s), the fused norm's launches checked against the child's
    module calls and zeroed (norm_checked). A child past ``timeout`` is
    killed."""
    try:
        rc = h["proc"].wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        h["proc"].kill()
        h["proc"].wait()
        rc = "killed at its timeout"
    wall = time.perf_counter() - h["t0"]
    out, err = h["out"].read_text(), h["err"].read_text()
    check(rc == 0, f"apv-torch {' '.join(h['args'])}: exit {rc}\n"
          f"{out[-1500:]}\n{err[-3000:]}")
    launches = None
    if h["counts"]:
        blob = json.loads(h["counts"].read_text())
        launches = norm_checked(blob["launches"], blob["norm_calls"],
                                f"apv-torch {' '.join(h['args'])[:120]}")
    return out, launches, wall


def run_cli(args: list[str], tmp: str, **kw):
    """The CLI with ``args`` in a child process, waited for (start_cli)."""
    return finish_cli(start_cli(args, tmp, **kw))


def cli_json(out: str) -> dict:
    """The JSON object the CLI printed last (evaluate, info)."""
    return json.loads(out[out.index("\n{") + 1 if "\n{" in out
                          else out.index("{"):])


def front_door_phase(dev) -> dict:
    """Phase 17: the port's CLI as a user runs it (module docstring)."""
    from apv_tpu_torch import latest_step
    from apv_tpu_torch.ops import kernels as K
    per_mnist = {"reparam": 1, "bernoulli": 1, "reparam_bwd": 1,
                 "bernoulli_bwd": 1}
    total = expected(K)
    walls, results = {}, {}

    def add(name, got, want):
        check(got == want, f"front_door {name} launches {got}, want {want}")
        for n in total:
            total[n] += got[n]

    with tempfile.TemporaryDirectory() as tmp:
        over = ["--set", f"results_dir={tmp}", "--set", "train.log_every=8",
                "--set", f"data.synthetic_size={FRONT_SYNTHETIC}"]
        run = Path(tmp) / "cifar_advprior_resnet"
        trace_dir = Path(tmp) / "trace"
        first, more = FRONT_STEPS
        out, launches, walls["train"] = run_cli(
            ["train", "--preset", "cifar_advprior_resnet", "--max-steps",
             str(first), "--trace-dir", str(trace_dir), *over], tmp,
            tag="train")
        check(f"trained to step {first}" in out, f"front_door train: {out}")
        add("train", launches, expected(K, **{n: first * c
                                               for n, c in PER_CIFAR_STEP.items()}))
        trace = trace_dir / "trace_steps_10-15.json"
        check(trace.exists(), f"front_door: no trace at {trace}")
        blob = trace.read_bytes()
        traced = {name: any(f"{fn}(".encode() in blob
                            or f"{fn}<".encode() in blob for fn in fns)
                  for name, fns in KERNEL_FNS.items() if name in PER_CIFAR_STEP}
        check(all(traced.values()), f"front_door: the trace of steps 10-15 "
              f"misses kernels {traced}")
        out, launches, walls["resume"] = run_cli(
            ["train", "--preset", "cifar_advprior_resnet", "--resume",
             "--max-steps", str(more), *over], tmp, tag="resume")
        check(f"trained to step {first + more}" in out
              and latest_step(run / "checkpoints") == first + more,
              f"front_door resume: {out}")
        add("resume", launches, expected(K, **{n: more * c for n, c in
                                                PER_CIFAR_STEP.items()}))
        for prior in ("model", "expost"):
            out, launches, walls[f"evaluate_{prior}"] = run_cli(
                ["evaluate", "--preset", "iwae_eval", "--checkpoint-dir",
                 str(run / "checkpoints"), "--prior", prior,
                 "--set", f"results_dir={tmp}", "--set",
                 f"eval.max_examples={BATCH}", "--set",
                 f"eval.batch_size={BATCH}"], tmp, tag=f"evaluate_{prior}")
            res = cli_json(out)
            check(res["prior"] == prior and res["iwae_k"] == 1000
                  and res["num_examples"] == BATCH
                  and math.isfinite(res["bits_per_dim"])
                  and 0 <= res["active_units"] <= res["z_dim"] == 128,
                  f"front_door evaluate {prior}: {res}")
            name = "eval.json" if prior == "model" else "eval_expost.json"
            saved = json.loads((Path(tmp) / "iwae_eval" / name).read_text())
            check(saved == res, f"front_door: {name} differs from the "
                  "printed result")
            chunks = 1000 // 25
            add(f"evaluate {prior}", launches,
                expected(K, reparam=chunks, disc_logistic=chunks))
            results[prior] = {k: res[k] for k in (
                "bits_per_dim", "nll_nats", "nll_nats_se", "log_partition",
                "log_partition_se", "adversarial_prior", "active_units")}
        # MNIST's run (its own results dir) beside the device-free child
        mnist = start_cli(["train", "--preset", "mnist_advprior",
                           "--max-steps", str(first), *over, "--set",
                           f"results_dir={tmp}/mnist"], tmp, tag="mnist")
        try:
            out, _, walls["info_info_run_presets"] = run_cli(
                [json.dumps([["info", "--results-dir", tmp],
                             ["info", "cifar_advprior_resnet",
                              "--results-dir", tmp], ["presets"]])],
                tmp, tag="no_cuda", child=NO_CUDA_CHILD, no_cuda=True)
        finally:
            out_m, launches, walls["mnist_train"] = finish_cli(mnist)
        parts = out.split('\n{"no_cuda_end"')
        check(len(parts) == 4 and json.loads(parts[-1].split("\n", 1)[1])
              == {"cuda_initialized": False},
              f"front_door info/presets without CUDA: {out[-2000:]}")
        listing, one = cli_json(parts[0]), cli_json(parts[1])
        check([r["name"] for r in listing["runs"]]
              == ["cifar_advprior_resnet"]
              and listing["runs"][0]["latest_checkpoint"] == first + more,
              f"front_door info: {listing}")
        check(one["checkpoint_steps"] == [first, first + more]
              and one["last_metrics"]["step"] == first
              and one["adversarial"] == "learned_prior",
              f"front_door info <name>: {one}")
        check("iwae_eval" in parts[2] and "cifar_flow" in parts[2],
              f"front_door presets: {parts[2]}")
        check(f"trained to step {first}" in out_m,
              f"front_door mnist: {out_m}")
        add("mnist train", launches, expected(K, **{
            n: first * c for n, c in per_mnist.items()}))
        emit("front_door", launches=total, wall_s=walls,
             trace_bytes=len(blob), traced_kernels=traced,
             evaluate=results, synthetic_size=FRONT_SYNTHETIC)
    return total


def dist_config(results_dir: str, name: str, *extra: str):
    """The flagship as phase 23 runs it: full width, the cut synthetic
    set, calls of one step, each logged (the logger's step time)."""
    from apv_tpu_torch import apply_overrides, get_preset
    return apply_overrides(get_preset("cifar_advprior_resnet"), [
        f"results_dir={results_dir}", f"name={name}", *DIST_SETS, *extra])


def dist_images() -> np.ndarray:
    return np.random.default_rng(SEED + 23).integers(
        0, 256, size=(BATCH, 32, 32, 3), dtype=np.uint8)


def dist_eval_config(n_k: int, *extra: str):
    from apv_tpu_torch import apply_overrides, get_preset
    return apply_overrides(get_preset("iwae_eval"),
                           [f"eval.k_shards={n_k}", *extra])


def step_ms(cfg) -> float:
    """ms a step from a run's logger (from step 1: step 0 has no time)."""
    return 1e3 * float(np.mean([r["step_time_s"] for r in read_metrics(cfg)
                                if "step_time_s" in r]))


def dist_rank(tmp: str, device: str, k: int, chunk: int, n_k: int,
              *extra: str) -> None:
    """Phase 23 (b, c) on one of two ranks sharing the card over gloo
    (started by ``start_distributed``, which hands it DIST_K and
    DIST_EXTRA): 8 steps through train_loop, the replicas compared, then
    evaluate_nll with eval.k_shards=n_k; the rank's results to
    ``<tmp>/rank<r>.json``."""
    from apv_tpu_torch import evaluate_nll, train_loop
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.parallel import multihost
    from apv_tpu_torch.parallel.dryrun import replicas_equal
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = multihost.process_index()
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = dist_config(tmp, "dist_w2", *extra)
    count_norms(K)
    K.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        state = train_loop(cfg, max_steps=DIST_STEPS, device=dev)
    sync()
    out = {"rank": rank,
           "train_launches": norm_checked(dict(K.launches), NORMS_NOW,
                                          f"rank {rank} train"),
           "replicas_equal": replicas_equal(state)}
    K.reset_launches()
    res = evaluate_nll(dist_eval_config(n_k, *extra), state.model, state.d,
                       dist_images(), k=k, chunk=chunk, batch_size=BATCH,
                       per_sample=True, seed=SEED, device=dev)
    sync()
    out.update(eval_launches=norm_checked(dict(K.launches), NORMS_NOW,
                                          f"rank {rank} IWAE"),
               per_sample=res["per_sample"].tolist(),
               log_partition=res["log_partition"])
    if rank == 0:
        out["ms_per_step"] = step_ms(cfg)
        out["losses"] = [r["loss"] for r in read_metrics(cfg) if "loss" in r]
    (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(out))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_distributed(tmp: str) -> dict:
    """Phase 23's children: (a) the CLI's world of one over NCCL, (b, c)
    the two gloo ranks."""
    from apv_tpu_torch.parallel.dryrun import start_ranks
    import atexit
    w1 = str(Path(tmp) / "dist_w1")
    sets = [a for o in (f"results_dir={w1}", "name=dist_w1", *DIST_SETS,
                        *DIST_EXTRA) for a in ("--set", o)]
    world1 = start_cli(
        ["train", "--distributed", "--preset", "cifar_advprior_resnet",
         "--max-steps", str(DIST_STEPS), "--device", DEVICE, *sets], tmp,
        tag="dist_w1", child=DIST_CHILD, env_add={
            "APV_COORDINATOR": f"127.0.0.1:{free_port()}",
            "APV_NUM_PROCESSES": "1", "APV_PROCESS_ID": "0"})
    w2 = Path(tmp) / "dist_w2"
    w2.mkdir()
    ranks = start_ranks(2, "chip_smoke:dist_rank", str(w2), DEVICE,
                        *DIST_K, *DIST_EXTRA, device=DEVICE,
                        backend="gloo", paths=(str(ROOT),))
    h = {"world1": world1, "ranks": ranks, "w1": w1, "w2": w2}
    atexit.register(stop_distributed, h)     # a phase before 23 may fail
    return h


def stop_distributed(h: dict) -> None:
    """Kill phase 23's children where they still run (a failed run)."""
    for p in [h["world1"]["proc"], *h["ranks"]["procs"]]:
        if p.poll() is None:
            p.kill()
            p.wait()


def distributed_phase(tmp: str, dev, h: dict) -> dict:
    """Phase 23 (module docstring): collects ``start_distributed``'s
    children and runs their comparisons here."""
    from apv_tpu_torch import (evaluate_nll, make_train_fns,
                               restore_checkpoint, train_loop)
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.parallel.dryrun import finish_ranks
    t0 = time.perf_counter()
    total = expected(K)

    def add(name, got, want):
        check(got == want, f"distributed {name} launches {got}, want {want}")
        for n in total:
            total[n] += got[n]

    per_run = expected(K, **{n: DIST_STEPS * c
                             for n, c in PER_CIFAR_STEP.items()})
    # (a) the world of one against no group, here
    out, launches, wall_w1 = finish_cli(h["world1"], timeout=300)
    check(f"trained to step {DIST_STEPS}" in out, f"distributed (a): {out}")
    add("(a) child", launches, per_run)
    cfg_a = dist_config(h["w1"], "dist_w1", *DIST_EXTRA)
    cfg_ref = dist_config(str(Path(tmp) / "dist_ref"), "dist_w1",
                          *DIST_EXTRA)
    with deterministic_cudnn(), contextlib.redirect_stdout(io.StringIO()):
        ref = train_loop(cfg_ref, max_steps=DIST_STEPS, device=dev)
    torch.cuda.synchronize()
    add("(a) without a group",
        norm_checked(dict(K.launches), NORMS_NOW, "(a)"), per_run)
    K.reset_launches()
    fns = make_train_fns(cfg_a, device=dev)
    child = restore_checkpoint(Path(h["w1"]) / "dist_w1" / "checkpoints",
                               fns.init_fn(cfg_a.train.seed))
    check(child.step == DIST_STEPS and states_equal(child, ref),
          "distributed (a): the world of one over NCCL differs from the "
          "run without a group")
    # (b, c) the two gloo ranks
    finish_ranks(h["ranks"], timeout=300)
    ranks = [json.loads((h["w2"] / f"rank{r}.json").read_text())
             for r in range(2)]
    k, chunk, n_k = DIST_K
    for r in ranks:
        check(r["replicas_equal"], f"distributed (b): rank {r['rank']}'s "
              "replica differs")
        add(f"(b) rank {r['rank']}", r["train_launches"], per_run)
        add(f"(c) rank {r['rank']}", r["eval_launches"],
            expected(K, reparam=k // n_k // chunk,
                     disc_logistic=k // n_k // chunk))
    check(len(ranks[0]["losses"]) == DIST_STEPS
          and all(math.isfinite(v) for v in ranks[0]["losses"]),
          f"distributed (b): losses {ranks[0]['losses']}")
    cfg_b = dist_config(str(h["w2"]), "dist_w2", *DIST_EXTRA)
    fns = make_train_fns(cfg_b, device=dev)
    st = restore_checkpoint(h["w2"] / "dist_w2" / "checkpoints",
                            fns.init_fn(cfg_b.train.seed))
    res = evaluate_nll(dist_eval_config(1, *DIST_EXTRA), st.model, st.d,
                       dist_images(), k=k, chunk=chunk, batch_size=BATCH,
                       per_sample=True, seed=SEED, device=dev)
    torch.cuda.synchronize()
    add("(c) one process", norm_checked(dict(K.launches), NORMS_NOW, "(c)"),
        expected(K, reparam=k // chunk, disc_logistic=k // chunk))
    want = np.asarray(res["per_sample"])
    got = np.asarray(ranks[0]["per_sample"])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    check(ranks[1]["per_sample"] == ranks[0]["per_sample"]
          and ranks[0]["log_partition"] == res["log_partition"]
          and rel <= 1e-5, f"distributed (c): the k-sharded IWAE is off "
          f"the one-process run by {rel} (rtol 1e-5); log Z "
          f"{ranks[0]['log_partition']} vs {res['log_partition']}")
    emit("distributed", launches=total, steps=DIST_STEPS,
         world1_nccl_bit_exact=True, world1_child_wall_s=wall_w1,
         world1_ms_per_step=step_ms(cfg_a),
         world1_launches=launches, gloo_ranks=2,
         gloo_rows_per_rank=cfg_b.train.batch_size // 2,
         gloo_replicas_equal=True,
         gloo_rank_launches=[{"train": r["train_launches"],
                              "iwae": r["eval_launches"]} for r in ranks],
         gloo_ms_per_step=ranks[0]["ms_per_step"],
         gloo_losses=ranks[0]["losses"],
         ksharded={"k": k, "chunk": chunk, "k_shards": n_k,
                   "images": BATCH, "max_rel_err": rel,
                   "nll_nats": res["nll_nats"],
                   "bits_per_dim": res["bits_per_dim"]},
         parent_s=time.perf_counter() - t0)
    return total


def d_masks(d32, z: torch.Tensor, x: torch.Tensor) -> dict:
    """The activation masks of the two Ds' LeakyReLUs (pre-activation >= 0,
    flax's derivative at 0) on the latent D's z and the pixel D's x, one
    [B, units] tensor a layer, by D."""
    from apv_tpu_torch.models.discriminator import leaky_relu
    lat, px = d32["latent"], d32["pixel"]
    masks = {"latent": [], "pixel": []}
    with torch.no_grad():
        h = z.to(torch.float32)
        for layer in lat.layers[:-1]:
            pre = layer(h)
            masks["latent"].append((pre >= 0).flatten(1))
            h = leaky_relu(pre, lat.negative_slope)
        h = x.permute(0, 3, 1, 2).to(px.dtype)
        for conv in px.convs:
            pre = conv(h)
            masks["pixel"].append((pre >= 0).flatten(1))
            h = leaky_relu(pre, px.negative_slope)
    return masks


def biadv_grad_check(cfg, state, x_in, x_target, dev, seed: int = SEED,
                     strict: bool = True) -> dict:
    """One biadversarial G step's gradients through the kernels against
    the step written out with the kernels' plain versions on the same
    Philox draws (f32 compute, the pixel D too, and deterministic cuDNN,
    as ``grad_check``). The D step runs no kernel: the kernels reach it
    through z_q and x̂ alone, so those are held to the plain path's
    (z at reparam's bar in phase 2, 1e-5; x̂ in [0, 1] at 1e-4), and its
    gradients (latent and pixel BCE, both R1 penalties, ``d_objective``)
    to the D loss written out on the same z_q and x̂ at 1e-3.

    Across the two paths' inputs the D gradients are held to max(1e-3,
    twice the witness) on the rows whose inputs give both Ds the same
    activation masks in every layer on both paths. The Ds are piecewise
    linear (LeakyReLU) and their R1 penalties differentiate through the
    masks: a pre-activation within the inputs' ~1e-6 of 0 changes slope
    and moves the D gradient by a finite step that no kernel causes. The
    units that flip and the rows they lie in are counted and reported;
    the flipped rows are left out of this comparison only (``rel_d`` holds
    the whole D step at the kernel path's own inputs). The witness is how
    far the same rows' D gradients move, on the plain path alone, when its
    inputs are mirrored about themselves by the kernels' difference (z_p −
    (z_k − z_p), x̂ likewise, clipped to [0, 1]) or moved by N(0, 1e-6²)
    noise: D's own sensitivity to inputs that close, which no kernel
    enters; the plain inputs' gradients computed twice give the run-to-run
    floor. ``seed`` shifts every draw of the check (the G step's Philox
    key, z_p, the noise); with ``strict`` False the failed bars are
    returned under ``failed`` instead of raised."""
    from apv_tpu_torch import build_model
    from apv_tpu_torch.models import PixelDiscriminator
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.training.losses import (
        decoder_output_to_likelihood_params, loss_scale)
    from apv_tpu_torch.training.step import d_objective, g_objective
    a = cfg.adversarial
    with deterministic_cudnn():
        m32 = build_model(cfg.model, dtype=torch.float32, device=dev)
        m32.load_state_dict(state.model.state_dict())
        px = PixelDiscriminator(cfg.model.image_shape, a.pixel_d_widths,
                                dtype=torch.float32).to(dev)
        px.load_state_dict(state.d["pixel"].state_dict())
        lat = state.d["latent"]
        d32 = torch.nn.ModuleDict({"latent": lat, "pixel": px})
        params = list(m32.parameters())
        loss_k, aux, z_k = g_objective(cfg, m32, lat, x_in, x_target, 1.0,
                                       generator=gen(seed + 5), px=px)
        grads_k = torch.autograd.grad(loss_k, params)

        mean, logvar = m32.encode(x_in)
        z = K.reparam_plain(mean, logvar, 1, *K.draw_key(gen(seed + 5)))[0]
        lik = decoder_output_to_likelihood_params(
            m32.decode(z), cfg.model.likelihood, x_target.shape[-1])
        x_hat = torch.clamp(lik[0], 0.0, 1.0)
        per = (K.disc_logistic_plain(x_target, *lik) + a.weight * lat(z)
               - a.pixel_weight * F.softplus(-px(x_hat)))
        loss_p = -(per.mean() - K.kl_plain(mean, logvar).mean()) \
            * loss_scale(cfg)
        grads_p = torch.autograd.grad(loss_p, params)

        zq, xh = z_k.detach(), aux["x_hat"]
        z_err = float((zq - z.detach()).abs().max()
                      / z.detach().abs().max())
        x_hat_err = float((xh - x_hat.detach()).abs().max())
        z_p = torch.randn(z.shape, device=dev,
                          generator=torch.Generator(dev).manual_seed(seed + 9))
        d_params = list(d32.parameters())
        total_k, _ = d_objective(cfg, d32, zq, z_p, x_target, xh)
        gd_k = torch.autograd.grad(total_k, d_params, allow_unused=True)
        s = a.label_smoothing

        def bce(real, fake):
            return (((1 - s) * F.softplus(-real) + s * F.softplus(real))
                    .mean() + ((1 - s) * F.softplus(fake)
                               + s * F.softplus(-fake)).mean())

        def r1(fn, x):
            x = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(fn(x).sum(), x, create_graph=True)
            return 0.5 * g.flatten(1).square().sum(1).mean()

        total_p = (bce(lat(zq), lat(z_p)) + a.r1_gamma * r1(lat, zq)
                   + bce(px(x_target), px(xh))
                   + a.r1_gamma * r1(px, x_target))
        gd_p = torch.autograd.grad(total_p, d_params, allow_unused=True)

        z0, x0 = z.detach(), x_hat.detach()
        # the rows on which both paths' inputs give both Ds the same masks
        m_k, m_p = d_masks(d32, zq, xh), d_masks(d32, z0, x0)
        flips = {part: [int((a_ != b_).sum()) for a_, b_ in
                        zip(m_k[part], m_p[part])] for part in m_k}
        same = torch.stack([(a_ == b_).all(dim=1) for part in m_k
                            for a_, b_ in zip(m_k[part], m_p[part])]).all(0)
        keep = same.nonzero().flatten()

        def d_grads(z_in, x_in_d, rows=keep):
            total, _ = d_objective(cfg, d32, z_in[rows], z_p[rows],
                                   x_target[rows], x_in_d[rows])
            return torch.autograd.grad(total, d_params, allow_unused=True)

        noise = torch.Generator(dev).manual_seed(seed + 10)
        moved = {"mirror": (2 * z0 - zq, (2 * x0 - xh).clamp(0.0, 1.0)),
                 "noise": (z0 + 1e-6 * z0.abs().max() * torch.randn(
                     z0.shape, device=dev, generator=noise),
                     (x0 + 1e-6 * torch.randn(
                         x0.shape, device=dev, generator=noise)).clamp(
                             0.0, 1.0))}
        gd_cross = d_grads(zq, xh)
        gd_plain = d_grads(z0, x0)
        gd_moved = {"repeat": d_grads(z0, x0),
                    **{how: d_grads(*v) for how, v in moved.items()}}
        if not strict:
            # the comparison over every row, flipped ones included, with
            # its witness: the form this check had before (reported only)
            every = torch.arange(z0.shape[0], device=dev)
            gd_every = (gd_k, d_grads(z0, x0, every),
                        {how: d_grads(*v, every) for how, v in moved.items()})
        torch.cuda.synchronize()

    def rel(gs_a, gs_b, names=None, part=""):
        names = names or [""] * len(gs_b)
        return max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                   for nm, x, y in zip(names, gs_a, gs_b)
                   if y is not None and nm.startswith(part))

    rel_g, rel_d = rel(grads_k, grads_p), rel(gd_k, gd_p)
    d_names = [nm for nm, _ in d32.named_parameters()]
    parts = ("latent", "pixel")
    cross = {part: rel(gd_cross, gd_plain, d_names, part) for part in parts}
    witness = {f"{how}_{part}": rel(g, gd_plain, d_names, part)
               for how, g in gd_moved.items() for part in parts}
    d_bar = max(1e-3, 2 * max(v for k_, v in witness.items()
                              if not k_.startswith("repeat")))
    every_rows = {}
    if not strict:
        g_k, g_p, g_m = gd_every
        w_every = max(rel(g, g_p, d_names, part) for g in g_m.values()
                      for part in parts)
        every_rows = {"d_grad_cross_path_every_row": {
            part: rel(g_k, g_p, d_names, part) for part in parts},
            "d_grad_cross_bar_every_row": max(1e-3, 2 * w_every)}
    rows = int(z0.shape[0])
    bars = [
        (rel_g <= 1e-3, f"biadv_train: G gradients kernels vs plain, "
         f"scale-relative {rel_g} > 1e-3"),
        (z_err <= 1e-5 and x_hat_err <= 1e-4, f"biadv_train: the D step's "
         f"inputs, kernels vs plain: z_q {z_err} (bar 1e-5 of max|z|), "
         f"x̂ {x_hat_err} (bar 1e-4)"),
        (rel_d <= 1e-3, f"biadv_train: D gradients vs the D loss written "
         f"out, scale-relative {rel_d} > 1e-3"),
        # a kernel fault moves every row: most must keep their masks
        (2 * len(keep) >= rows, f"biadv_train: {rows - len(keep)} of "
         f"{rows} rows change a D activation mask across the paths' "
         f"inputs (flipped units {flips})"),
        (max(cross.values()) <= d_bar, f"biadv_train: D gradients at the "
         f"kernels' inputs vs the plain path's on the {len(keep)} rows of "
         f"equal masks, scale-relative {cross} > {d_bar} (witness "
         f"{witness})")]
    failed = [msg for ok, msg in bars if not ok]
    if strict and failed:
        check(False, failed[0])
    return {"grad_max_scale_rel_err": rel_g, "d_grad_max_scale_rel_err":
            rel_d, "d_grad_cross_path": cross, "d_grad_witness": witness,
            "d_grad_cross_bar": d_bar, **every_rows,
            "d_mask_flips": flips, "d_rows_compared": len(keep),
            "d_rows": rows,
            "d_input_z_rel_err": z_err, "d_input_x_hat_err":
            x_hat_err, "loss_kernels": float(loss_k.detach()),
            "loss_plain": float(loss_p.detach()),
            "d_total": float(total_k.detach()), "failed": failed}


def biadv_seeds(n: int, dev) -> int:
    """``--biadv-seeds N``: the biadversarial flagship trained as phase 18
    trains it (on the synthetic set of phases 14-16), then
    ``biadv_grad_check`` at N seeds of its inputs: seed k takes the k-th
    batch of 256, its own dequantization noise and check draws (k = 0 is
    phase 18's check). One ``biadv_seed`` line a seed with the flipped
    units, the rows compared, the held comparison and the every-row one
    it replaced; then a summary. Returns 1 if a seed failed a bar."""
    from apv_tpu_torch.data.preprocess import (normalize_center,
                                               uniform_dequantize)
    from apv_tpu_torch.training.loop import load_train_arrays
    with tempfile.TemporaryDirectory() as tmp:
        arrays, _ = load_train_arrays(prior_config("cifar_gb", tmp,
                                                   PRIOR_STEPS))
        cfg = prior_config("cifar_advprior_resnet", tmp, BIADV_STEPS,
                           "name=cifar_biadv", *BIADV)
        state, *_ = checked_train("biadv_seeds", cfg, arrays, dev,
                                  PER_CIFAR_STEP)
        b = cfg.train.batch_size
        failed, every_failed = [], []
        for k in range(n):
            image = torch.from_numpy(arrays["image"][k * b:(k + 1) * b]).to(
                dev)
            u = torch.rand(image.shape, device=dev, generator=torch.Generator(
                dev).manual_seed(SEED + 7 + 100 * k))
            r = biadv_grad_check(cfg, state, normalize_center(
                uniform_dequantize(image, u=u)), image.to(torch.float32)
                / 255.0, dev, seed=SEED + 100 * k, strict=False)
            emit("biadv_seed", seed_index=k, **r)
            if r["failed"]:
                failed.append(k)
            if max(r["d_grad_cross_path_every_row"].values()) \
                    > r["d_grad_cross_bar_every_row"]:
                every_failed.append(k)
        emit("biadv_seeds", seeds=n, failed=failed,
             every_row_form_failed=every_failed,
             card=torch.cuda.get_device_name(0))
    return 1 if failed else 0


def biadv_train_phase(arrays, tmp: str, dev):
    """Phase 18 (module docstring). Returns (launches, cfg)."""
    from apv_tpu_torch import make_train_fns, ood_score, restore_checkpoint
    from apv_tpu_torch.data.preprocess import (normalize_center,
                                               uniform_dequantize)
    from apv_tpu_torch.ops import kernels as K
    cfg = prior_config("cifar_advprior_resnet", tmp, BIADV_STEPS,
                       "name=cifar_biadv", *BIADV)
    a = cfg.adversarial
    check_flagship_width("biadv_train", cfg)
    check(a.enabled and a.variant == "biadversarial" and a.r1_gamma == 1.0
          and a.d_spectral_norm and a.d_reuse_posterior
          and tuple(a.pixel_d_widths) == (32, 64, 128),
          f"biadv_train: adversarial section {a}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, launches, records, wall, (first, last) = checked_train(
        "biadv_train", cfg, arrays, dev, PER_CIFAR_STEP)
    peak = torch.cuda.max_memory_allocated()
    keys = ("d_loss", "px_d_loss", "d_r1", "px_d_r1", "g_px", "px_d_acc")
    check(all(k in r for r in records for k in keys),
          f"biadv_train: metrics {sorted(records[-1])}")
    fresh = make_train_fns(cfg, device=dev).init_fn(cfg.train.seed)
    restore_checkpoint(Path(tmp) / cfg.name / "checkpoints", fresh)
    check(states_equal(fresh, state), "biadv_train: the restored state "
          "differs from the trained one")
    image = torch.from_numpy(arrays["image"][:cfg.train.batch_size]).to(dev)
    u = torch.rand(image.shape, generator=torch.Generator(dev).manual_seed(
        SEED + 7), device=dev)
    grads = biadv_grad_check(cfg, state, normalize_center(
        uniform_dequantize(image, u=u)), image.to(torch.float32) / 255.0, dev)
    del state, fresh
    step_s = loop_step_s(prior_config(
        "cifar_advprior_resnet", tmp, TIMED_STEPS, "name=cifar_biadv_timed",
        "train.log_every=8", *BIADV), arrays, dev)

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    res = ood_score("ood_suite", overrides=[
        f"results_dir={tmp}", "ood.score=pixel_d"], checkpoint_dir=str(
            Path(tmp) / cfg.name / "checkpoints"), both=True, seed=SEED,
        device=dev)
    torch.cuda.synchronize()
    ood_wall = time.perf_counter() - t0
    ood_launches = path_counts(K)
    check(ood_launches == expected(K), f"biadv_train pixel_d launches "
          f"{ood_launches} (one conv D forward a batch: no port kernel)")
    o = cfg.ood
    n_rows = (o.max_examples // o.batch_size) * o.batch_size
    for r in (res["forward"], res["reverse"]):
        check(r["score"] == "pixel_d" and r["n_in"] == r["n_ood"] == n_rows
              and all(0.0 <= r[k] <= 1.0 for k in (
                  "auroc_in_vs_ood", "auroc_ood_vs_in", "fpr_at_95_tpr"))
              and math.isfinite(r["in_mean"]) and math.isfinite(
                  r["ood_mean"]), f"biadv_train pixel_d: {r}")
    imgs, s_launches, lines, s_wall = sample_png(
        "biadv_train", "cifar_advprior_resnet", tmp, dev, name=cfg.name)
    check(s_launches == expected(K), f"biadv_train sample launches "
          f"{s_launches}")
    diag = next(ln["sampler_diagnostics"] for ln in lines
                if "sampler_diagnostics" in ln)
    check(diag["sir_pool"] == SAMPLE_N * 16
          and 1.0 <= diag["sir_ess"] <= SAMPLE_N * 16,
          f"biadv_train: SIR through the SN latent D {diag}")
    last_rec = records[-1]
    emit("biadv_train", preset="cifar_advprior_resnet", variant=a.variant,
         r1_gamma=a.r1_gamma, d_spectral_norm=a.d_spectral_norm, batch=256,
         steps=BIADV_STEPS, launches=launches, loss_first8=first,
         loss_last8=last, last_step={k: v for k, v in last_rec.items()
                                     if k != "step"},
         wall_s_checked_run=wall, ms_per_step=step_s * 1e3,
         images_per_s=cfg.train.batch_size / step_s,
         max_memory_allocated_bytes=peak,
         max_memory_allocated_gib=peak / 2 ** 30,
         ood_pixel_d=res, ood_wall_s=ood_wall, sample_wall_s=s_wall,
         sample_diagnostics=diag, sample_images_mean=float(imgs.mean()),
         card=torch.cuda.get_device_name(0), **grads)
    return launches, cfg


# ---------------------------------------------------------------------------
# phases 19-21: the training knobs, the mixture head, the visualizer
# ---------------------------------------------------------------------------

KNOBS = ("adversarial.d_lr_schedule=floor_adaptive", "train.ema_decay=0.999",
         "train.grad_accum=2")
KNOBS_STEPS, KNOBS_SPLIT = 24, 13   # a resume inside an accumulation window
SYNC_STEPS = 8                      # steps counted under the sync debug mode
MIX = ("model.likelihood=disc_logistic_mix", "model.mix_components=5")


def sync_calls(cfg, arrays, dev) -> list[str]:
    """Where ``torch.cuda.set_sync_debug_mode("warn")`` reports a
    synchronizing CUDA call (file:line of the Python caller) over
    SYNC_STEPS calls of ``train_step`` of ``cfg``, after one warm-up
    step."""
    from apv_tpu_torch import make_train_fns
    fns = make_train_fns(cfg, device=dev)
    state = fns.init_fn(cfg.train.seed)
    b = cfg.train.batch_size
    data = torch.from_numpy(arrays["image"][:(SYNC_STEPS + 1) * b]).to(dev)
    fns.train_step(state, {"image": data[:b]})
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(1, SYNC_STEPS + 1):
                fns.train_step(state, {"image": data[i * b:(i + 1) * b]})
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return ["/".join(Path(w.filename).parts[-3:]) + f":{w.lineno}"
            for w in caught if "synchroniz" in str(w.message)]


def knobs_train_phase(arrays, tmp: str, dev, flagship_s: float):
    """Phase 19 (module docstring); ``flagship_s``: phase 8's s a step.
    Returns (launches, cfg)."""
    from apv_tpu_torch import (evaluate, evaluate_nll, make_train_fns,
                               restore_checkpoint, train_loop)
    from apv_tpu_torch.api import _adopt_checkpoint_arch, _resolve
    from apv_tpu_torch.eval.run import eval_arrays
    from apv_tpu_torch.ops import kernels as K
    cfg = prior_config("cifar_advprior_resnet", tmp, KNOBS_STEPS,
                       "name=cifar_knobs", "train.steps_per_call=1", *KNOBS)
    check_flagship_width("knobs_train", cfg, steps_per_call=1)
    check((cfg.adversarial.d_lr_schedule, cfg.train.ema_decay,
           cfg.train.grad_accum) == ("floor_adaptive", 0.999, 2),
          f"knobs_train: the knobs are not on: {cfg.train}")
    per_step = PER_CIFAR_STEP
    with deterministic_cudnn():
        state, launches, records, wall, (first, last) = checked_train(
            "knobs_train", cfg, arrays, dev, per_step)
    check(state.opt.count == state.d_opt.count == KNOBS_STEPS // 2
          and state.opt.mini_step == state.d_opt.mini_step == 0,
          f"knobs_train: updates {state.opt.count}/{state.d_opt.count}")
    factors = [r["d_lr_factor"] for r in records]
    check(all(0.0 <= f <= 1.0 for f in factors),
          f"knobs_train: d_lr_factor outside [0, 1]: {factors}")

    # the same run cut at micro-step 13, mid-window, and resumed to 24
    split = dataclasses.replace(cfg, name="cifar_knobs_split")
    torch.cuda.synchronize()
    K.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()), deterministic_cudnn():
        cut = train_loop(split, max_steps=KNOBS_SPLIT, arrays=arrays,
                         device=dev)
        check(cut.opt.mini_step == cut.d_opt.mini_step == 1,
              "knobs_train: the cut is not inside an accumulation window")
        del cut
        resumed = train_loop(split, resume=True, arrays=arrays, device=dev)
    torch.cuda.synchronize()
    split_launches = path_counts(K)
    check(split_launches == expected(K, **{n: KNOBS_STEPS * c
                                           for n, c in per_step.items()}),
          f"knobs_train split run launches {split_launches}")
    check(states_equal(resumed, state), "knobs_train: the run resumed at "
          f"micro-step {KNOBS_SPLIT} differs from the straight run "
          "(shadow and accumulators included)")
    del resumed

    # api.evaluate reads the shadow: its bits/dim is the shadow's
    over = [f"results_dir={tmp}", f"eval.max_examples={BATCH}",
            f"eval.batch_size={BATCH}"]
    ckpt_dir = str(Path(tmp) / cfg.name / "checkpoints")
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    res = evaluate("iwae_eval", overrides=over, checkpoint_dir=ckpt_dir,
                   device=dev)
    torch.cuda.synchronize()
    eval_wall = time.perf_counter() - t0
    eval_launches = path_counts(K)
    cfg_e = _adopt_checkpoint_arch(_resolve("iwae_eval", over), over,
                                   ckpt_dir)
    fresh = make_train_fns(cfg, device=dev).init_fn(cfg.train.seed)
    restore_checkpoint(ckpt_dir, fresh)
    check(states_equal(fresh, state), "knobs_train: the restored state "
          "differs from the trained one")
    images = eval_arrays(cfg_e, None,
                         max_examples=cfg_e.eval.max_examples)["image"]
    bpd = {}
    for which, model in (("shadow", fresh.ema_model),
                         ("raw", fresh.model)):
        bpd[which] = evaluate_nll(cfg_e, model, fresh.d, images,
                                  device=dev)["bits_per_dim"]
    chunks = 1000 // 25
    check(eval_launches == expected(K, reparam=chunks, disc_logistic=chunks),
          f"knobs_train evaluate launches {eval_launches}")
    check(math.isfinite(res["bits_per_dim"]) and res["iwae_k"] == 1000
          and res["num_examples"] == BATCH
          and abs(res["bits_per_dim"] - bpd["shadow"]) <= 1e-6
          and abs(res["bits_per_dim"] - bpd["raw"]) > 1e-4,
          f"knobs_train: api.evaluate's bits/dim {res['bits_per_dim']} is "
          f"not the shadow's {bpd['shadow']} (raw {bpd['raw']})")
    del fresh

    syncs = {"flagship": sync_calls(prior_config(
        "cifar_advprior_resnet", tmp, KNOBS_STEPS, "name=cifar_sync"),
        arrays, dev), "knobs": sync_calls(cfg, arrays, dev)}
    check(len(syncs["knobs"]) <= len(syncs["flagship"]), f"knobs_train: "
          f"the throttle, the EMA and the accumulation add synchronizing "
          f"calls {syncs}")
    step_s = loop_step_s(prior_config(
        "cifar_advprior_resnet", tmp, TIMED_STEPS, "name=cifar_knobs_timed",
        "train.log_every=8", *KNOBS), arrays, dev)
    emit("knobs_train", preset="cifar_advprior_resnet", knobs=list(KNOBS),
         batch=256, steps=KNOBS_STEPS, resumed_at=KNOBS_SPLIT,
         launches=launches, loss_first8=first, loss_last8=last,
         d_lr_factor_range=[min(factors), max(factors)],
         last_step={k: v for k, v in records[-1].items() if k != "step"},
         resume_bit_exact=True, wall_s_checked_run=wall,
         ms_per_step=step_s * 1e3,
         flagship_ms_per_step=flagship_s * 1e3,
         images_per_s=cfg.train.batch_size / step_s,
         evaluate=res, evaluate_wall_s=eval_wall, bits_per_dim_shadow=
         bpd["shadow"], bits_per_dim_raw=bpd["raw"],
         sync_calls_per_8_steps={k: len(v) for k, v in syncs.items()},
         sync_call_sites=syncs, card=torch.cuda.get_device_name(0))
    return {n: launches[n] + split_launches[n] + eval_launches[n]
            for n in K.launches}, cfg


def mix_op_ms(cfg, dev) -> float:
    """CUDA-event ms of the mixture likelihood's forward and backward at
    the train step's shape (batch 256, 32x32x3, K components)."""
    from apv_tpu_torch import ops
    from apv_tpu_torch.training.losses import \
        decoder_output_to_likelihood_params
    g = torch.Generator(dev).manual_seed(SEED + 50)
    kk = cfg.model.mix_components
    out = torch.randn((cfg.train.batch_size, 32, 32, 9 * kk), device=dev,
                      generator=g).requires_grad_(True)
    x = torch.randint(0, 256, (cfg.train.batch_size, 32, 32, 3), device=dev,
                      generator=g).to(torch.float32) / 255.0

    def fwd_bwd():
        lik = decoder_output_to_likelihood_params(out, "disc_logistic_mix", 3)
        torch.autograd.grad(ops.disc_logistic_mix_recon_ll(x, *lik).sum(),
                            out)

    return cuda_ms(fwd_bwd, 20)


def mix_train_phase(arrays, tmp: str, dev, flagship_s: float):
    """Phase 20 (module docstring); ``flagship_s``: phase 8's s a step.
    Returns (launches, cfg, the mixture op's forward and backward in
    ms)."""
    from apv_tpu_torch import evaluate_nll, get_preset
    from apv_tpu_torch.data.preprocess import (normalize_center,
                                               uniform_dequantize)
    from apv_tpu_torch.ops import kernels as K
    cfg = prior_config("cifar_advprior_resnet", tmp, PRIOR_STEPS,
                       "name=cifar_mix", *MIX)
    check_flagship_width("mix_train", cfg)
    check(cfg.model.likelihood == "disc_logistic_mix"
          and cfg.model.mix_components == 5, f"mix_train: {cfg.model}")
    state, launches, records, wall, (first, last) = checked_train(
        "mix_train", cfg, arrays, dev, {"reparam": 1, "reparam_bwd": 1})
    check(state.model.decoder.head.weight.shape[0] == 45,
          "mix_train: the decoder head is not 3·K·C = 45 channels")
    image = torch.from_numpy(arrays["image"][:cfg.train.batch_size]).to(dev)
    u = torch.rand(image.shape, generator=torch.Generator(dev).manual_seed(
        SEED + 7), device=dev)
    grads = grad_check(cfg, state, normalize_center(uniform_dequantize(
        image, u=u)), image.to(torch.float32) / 255.0, dev, phase="mix_train")

    cfg_k = dataclasses.replace(get_preset("iwae_eval"), model=cfg.model)
    images = arrays["image"][-BATCH:]
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    res = evaluate_nll(cfg_k, state.model, state.d, images, k=1000,
                       chunk=25, batch_size=BATCH, seed=SEED, device=dev)
    torch.cuda.synchronize()
    iwae_wall = time.perf_counter() - t0
    iwae_launches = path_counts(K)
    check(iwae_launches == expected(K, reparam=40)
          and math.isfinite(res["bits_per_dim"]),
          f"mix_train IWAE k=1000: {res}, launches {iwae_launches}")
    samples = {}
    for mode in ("mean", "sample"):
        imgs, s_launches, _, s_wall = sample_png(
            "mix_train", "cifar_advprior_resnet", tmp, dev, name=cfg.name,
            mode=mode)
        check(s_launches == expected(K), f"mix_train sample launches "
              f"{s_launches}")
        samples[mode] = {"wall_s": s_wall, "mean": float(imgs.mean()),
                         "levels": int(torch.unique(imgs).numel())}
    step_s = loop_step_s(prior_config(
        "cifar_advprior_resnet", tmp, TIMED_STEPS, "name=cifar_mix_timed",
        "train.log_every=8", *MIX), arrays, dev)
    op_ms = mix_op_ms(cfg, dev)
    emit("mix_train", preset="cifar_advprior_resnet", likelihood=
         cfg.model.likelihood, mix_components=cfg.model.mix_components,
         batch=256, steps=PRIOR_STEPS, launches=launches, loss_first8=first,
         loss_last8=last, last_step={k: v for k, v in records[-1].items()
                                     if k != "step"},
         wall_s_checked_run=wall, ms_per_step=step_s * 1e3,
         flagship_ms_per_step=flagship_s * 1e3,
         mix_fwd_bwd_ms=op_ms, iwae_k1000=res, iwae_wall_s=iwae_wall,
         samples=samples, card=torch.cuda.get_device_name(0), **grads)
    return ({n: launches[n] + iwae_launches[n] for n in K.launches}, cfg,
            op_ms)


def start_visualize_cli(cfg, tmp: str) -> dict:
    """Phase 21's `apv-torch sample --visualize latent` child on
    knobs_train's checkpoint (``start_cli``), started as phase 20 begins:
    its start-up (~8 s of torch import and CUDA) runs beside phase 20 on
    other host cores."""
    png = Path(tmp) / "cli_latent_scatter.png"
    child = start_cli(["sample", "--visualize", "latent", "--preset",
                       "cifar_advprior_resnet", "--checkpoint-dir",
                       str(Path(tmp) / cfg.name / "checkpoints"), "--set",
                       f"results_dir={tmp}", "--refine", str(SAMPLE_REFINE),
                       "--out", str(png)], tmp, tag="visualize")
    return {**child, "png": png}


def visualize_phase(cfg, tmp: str, dev, child: dict) -> dict:
    """Phase 21 (module docstring): on knobs_train's checkpoint, beside
    ``child`` (``start_visualize_cli``), which it waits for."""
    from apv_tpu_torch import make_train_fns, restore_checkpoint, visualize
    from apv_tpu_torch.eval.run import _prep_eval_batch, eval_arrays
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.sampling.run import reconstruct_images
    from apv_tpu_torch.utils.png import decode_png
    ckpt_dir = str(Path(tmp) / cfg.name / "checkpoints")
    cli_png = child["png"]
    over = [f"results_dir={tmp}"]
    n, steps = 8, 8
    shapes = {"reconstruct": (2 * 34 - 2, n * 34 - 2, 3),
              "interpolate": (n * 34 - 2, steps * 34 - 2, 3),
              "latent": (512, 512, 3)}
    outs, walls, stds = {}, {}, {}
    try:
        torch.cuda.synchronize()
        K.reset_launches()
        for what in shapes:
            path = Path(tmp) / f"viz_{what}.png"
            t0 = time.perf_counter()
            outs[what] = visualize("cifar_advprior_resnet", overrides=over,
                                   checkpoint_dir=ckpt_dir, what=what, n=n,
                                   steps=steps, seed=SEED, out_path=str(path),
                                   refine=SAMPLE_REFINE if what == "latent"
                                   else 0, device=dev)
            torch.cuda.synchronize()
            walls[what] = time.perf_counter() - t0
            img = decode_png(path.read_bytes())
            stds[what] = float(img.std())
            check(img.shape == shapes[what] and stds[what] > 1.0,
                  f"visualize {what}: PNG {img.shape}, std {stds[what]}")
        launches = path_counts(K)
    finally:
        out, cli_launches, walls["cli_latent"] = finish_cli(child)
    check(launches == expected(K, reparam=1), f"visualize launches "
          f"{launches} (reparam once, in reconstruct)")
    check(cli_launches == expected(K) and "wrote latent grid" in out
          and decode_png(cli_png.read_bytes()).shape == (512, 512, 3),
          f"visualize CLI: {out[-500:]}, launches {cli_launches}")
    lat = outs["latent"]
    check(lat["posterior"].shape == (256, 2) and 0.0 < lat["explained"] <= 1
          and {"shaped_prior", "prior", "expost_prior"} <= set(lat),
          f"visualize latent: {sorted(lat)}")
    # reconstruct read the shadow: the same draw through the shadow
    fresh = make_train_fns(cfg, device=dev).init_fn(cfg.train.seed)
    restore_checkpoint(ckpt_dir, fresh)
    x_np, _ = _prep_eval_batch(cfg, eval_arrays(cfg, None,
                                                max_examples=n)["image"][:n])
    want = reconstruct_images(fresh.ema_model, torch.from_numpy(x_np).to(dev),
                              cfg.model.likelihood, 3, seed=SEED)
    check(torch.equal(outs["reconstruct"], want), "visualize: reconstruct "
          "did not read the EMA shadow")
    emit("visualize", checkpoint=cfg.name, wall_s=walls, png_std=stds,
         launches=launches, cli_launches=cli_launches,
         latent_explained=lat["explained"],
         latent_clouds=sorted(k for k in lat if k != "explained"),
         interpolate_shape=list(outs["interpolate"].shape))
    return {n_: launches[n_] + cli_launches[n_] for n_ in K.launches}


# ---------------------------------------------------------------------------
# phase 22: the serving export
# ---------------------------------------------------------------------------

# A child running the CLI's main() on each argv of the JSON list in argv[1]
# in turn, each command's exit code and refusal printed as one JSON line.
EXPORT_CHILD = """\
import json, sys
from apv_tpu_torch.cli import main
for argv in json.loads(sys.argv[1]):
    try:
        code, said = main(argv), ""
    except SystemExit as e:
        code, said = (1 if isinstance(e.code, str) else e.code), str(e)
    print(json.dumps({"export_argv": argv, "code": code, "said": said}),
          flush=True)
"""
EXPORT_BATCHES = (64, 16, 1)  # one scorer artifact, three batch sizes
CLI_REFINE = 2                # the CLI child's sampler: MALA steps


def start_export_cli(cfg, tmp: str) -> dict:
    """Phase 22's `apv-torch export` child on knobs_train's checkpoint
    (``start_cli``): the scorer, the sampler with CLI_REFINE MALA steps
    (the phase exports the 20-step one and an int8 twin of this one
    itself), and a tempered scorer, which must be refused."""
    common = ["--preset", "cifar_advprior_resnet", "--checkpoint-dir",
              str(Path(tmp) / cfg.name / "checkpoints"), "--set",
              f"results_dir={tmp}"]
    outs = {w: Path(tmp) / f"cli_{w}.pt2" for w in ("scorer", "sampler")}
    argvs = [["export", "--what", "scorer", *common, "--out",
              str(outs["scorer"])],
             ["export", "--what", "sampler", "--refine", str(CLI_REFINE),
              *common, "--out", str(outs["sampler"])],
             ["export", "--what", "scorer", "--temperature", "0.8",
              *common, "--out", str(Path(tmp) / "cli_refused.pt2")]]
    child = start_cli([json.dumps(argvs)], tmp, tag="export",
                      child=EXPORT_CHILD)
    return {**child, "outs": outs}


@contextlib.contextmanager
def export_split(into: dict):
    """``torch.export``'s trace and save inside the block, their wall
    seconds written to ``into`` as ``trace`` and ``save``: wrappers over
    the two calls, in this script only."""
    real = torch.export.export, torch.export.save

    def wrap(name, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                into[name] = time.perf_counter() - t0
        return run

    torch.export.export = wrap("trace", real[0])
    torch.export.save = wrap("save", real[1])
    try:
        yield
    finally:
        torch.export.export, torch.export.save = real


def export_phase(cfg, tmp: str, dev, child: dict) -> dict:
    """Phase 22 (module docstring): the serving artifacts of knobs_train's
    EMA checkpoint and of a seeded full-width mnist_advprior, beside
    ``child`` (``start_export_cli``), which it waits for."""
    import importlib.util
    from apv_tpu_torch import (build_model, export_artifact, get_preset,
                               load_exported, make_latent_d, make_scorer,
                               make_train_fns, restore_checkpoint, serving)
    from apv_tpu_torch.data.preprocess import static_binarize
    from apv_tpu_torch.eval.iwae_eval import estimate_log_partition
    from apv_tpu_torch.eval.run import eval_arrays
    from apv_tpu_torch.models import latent_d_params
    from apv_tpu_torch.ops import kernels as K
    ckpt_dir = str(Path(tmp) / cfg.name / "checkpoints")
    over = [f"results_dir={tmp}"]
    paths = {k: Path(tmp) / f"export_{k}.pt2"
             for k in ("scorer", "sampler", "sampler_int8", "mnist_scorer")}
    secs, errs, bars, ms, per_call = {}, {}, {}, {}, {}
    launches = expected(K)

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if key.startswith("export_"):
            with export_split(secs.setdefault(f"{key}_trace_save", {})):
                out = fn()
        else:
            out = fn()
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        return out

    def score(tag, art, ref, x, seed, want_launches, plain, norms=0):
        """One artifact call with the counters zeroed around it (after a
        warm-up call), held to ``ref`` (make_scorer, the same key: the
        same kernels, expected bit-equal) and to ``plain`` (the plain
        ops, at scorer_phase's bar); ``norms``: the fused norm's forward
        launches the graph must make (its apv::rmsnorm_act nodes)."""
        art(x, torch.tensor(seed))                         # warm up
        torch.cuda.synchronize()
        K.reset_launches()
        got = art(x, torch.tensor(seed))
        torch.cuda.synchronize()
        per_call[tag] = counts = path_counts(K, {"rmsnorm_act": norms})
        for name in launches:
            launches[name] += counts[name]
        check(counts == want_launches, f"{tag} artifact: launches {counts}")
        check(got.shape == (x.shape[0],) and bool(torch.isfinite(got).all()),
              f"{tag} artifact: ELBO not finite or of the wrong shape")
        want = ref(x, key=(seed, 0))
        errs[tag] = float((got - want).abs().max())
        bars[tag] = 1e-5 * float(want.abs().max())
        check(errs[tag] <= bars[tag], f"{tag} artifact: max |Δ| vs "
              f"make_scorer {errs[tag]} > {bars[tag]}")
        # plain reparam (z within ulps of the kernel's), the decoder on
        # it, plain kl and likelihood sums: as scorer_phase's bar
        errs[f"{tag}_vs_plain"] = float((got - plain).abs().max())
        bars[f"{tag}_vs_plain"] = 5e-2 + 1e-5 * float(plain.abs().max())
        check(errs[f"{tag}_vs_plain"] <= bars[f"{tag}_vs_plain"],
              f"{tag} artifact: max |Δ| vs the plain ops "
              f"{errs[f'{tag}_vs_plain']} > {bars[f'{tag}_vs_plain']}")
        return got

    try:
        # the scorer of the knobs' EMA checkpoint through the API (restore,
        # log Z, trace, save), the samplers of the same restored shadow
        torch.cuda.synchronize()
        K.reset_launches()
        timed("export_scorer", lambda: export_artifact(
            "cifar_advprior_resnet", overrides=over, checkpoint_dir=ckpt_dir,
            what="scorer", out_path=str(paths["scorer"]), device=dev))
        fresh = make_train_fns(cfg, device=dev).init_fn(cfg.train.seed)
        restore_checkpoint(ckpt_dir, fresh)
        d = latent_d_params(cfg.adversarial.variant, fresh.d)
        for key, quantize, refine in (("sampler", None, SAMPLE_REFINE),
                                      ("sampler_int8", "int8", CLI_REFINE)):
            timed(f"export_{key}", lambda key=key, q=quantize, r=refine:
                  serving.export_sampler(cfg, fresh.ema_model, d, paths[key],
                                         quantize=q, refine_steps=r,
                                         device=dev))
        exporting = path_counts(K)
        check(exporting == expected(K), f"export launched {exporting}")
        scorer = timed("load_scorer", lambda: load_exported(paths["scorer"]))

        # held against make_scorer on the restored shadow, the same key,
        # and against the plain ops
        with torch.inference_mode():
            log_z = float(estimate_log_partition(d, cfg.model.z_dim, seed=0,
                                                 device=dev))
        ref = make_scorer(cfg, fresh.ema_model, d, log_z, device=dev)
        images = eval_arrays(cfg, None, max_examples=max(EXPORT_BATCHES))
        x_all = torch.from_numpy(images["image"].astype(np.float32)
                                 / 255.0).to(dev)
        outs = {}
        enc_norms = norms_a_forward(fresh.ema_model.encoder)
        dec_norms = norms_a_forward(fresh.ema_model.decoder)
        for b in EXPORT_BATCHES:
            x, seed = x_all[:b], SEED + b
            outs[b] = score(f"scorer_b{b}", scorer, ref, x, seed,
                            expected(K, reparam=1, kl=1, disc_logistic=1),
                            plain_elbo(cfg, fresh.ema_model, d, x, log_z,
                                       seed, plain_z=True),
                            norms=enc_norms + dec_norms)
        x64, seed_t = x_all[:64], torch.tensor(SEED)
        ms["scorer_artifact"] = cuda_ms(lambda: scorer(x64, seed_t), 10)
        ms["scorer_in_process"] = cuda_ms(lambda: ref(x64, key=(SEED, 0)),
                                          10)

        # the 20-step sampler; the int8 one is held to the CLI's below
        s32 = timed("load_sampler", lambda: load_exported(paths["sampler"]))
        s8 = load_exported(paths["sampler_int8"])
        torch.cuda.synchronize()
        K.reset_launches()
        a, a8 = s32(torch.tensor(SEED)), s8(torch.tensor(SEED))
        torch.cuda.synchronize()
        sampling = path_counts(K, {"rmsnorm_act": 2 * dec_norms})
        check(sampling == expected(K), f"sampler artifacts launched "
              f"{sampling}: their path holds no kernel but the decoder's "
              "norms")
        check(tuple(a.shape) == (cfg.eval.batch_size, 32, 32, 3)
              and bool(((a >= 0) & (a <= 1)).all())
              and torch.equal(s32(torch.tensor(SEED)), a)
              and not torch.equal(s32(torch.tensor(SEED + 1)), a),
              f"sampler artifact: shape {tuple(a.shape)}, not in [0, 1] "
              "or not deterministic in its seed")
        ms["sampler_artifact"] = cuda_ms(lambda: s32(seed_t), 3, warmup=1)

        # an MNIST scorer at full width from seeded weights: bernoulli
        cfg_m = get_preset("mnist_advprior")
        model_m = build_model(cfg_m.model, device=dev, seed=SEED + 40)
        d_m = make_latent_d(cfg_m.adversarial, cfg_m.model.z_dim,
                            device=dev, seed=SEED + 41)
        timed("export_mnist_scorer", lambda: serving.export_scorer(
            cfg_m, model_m, paths["mnist_scorer"], d=d_m, device=dev))
        mscorer = load_exported(paths["mnist_scorer"])
        with torch.inference_mode():
            log_z_m = float(estimate_log_partition(d_m, cfg_m.model.z_dim,
                                                   seed=0, device=dev))
        ref_m = make_scorer(cfg_m, model_m, d_m, log_z_m, device=dev)
        xb = torch.from_numpy(static_binarize(
            synthetic_digits(BATCH, SEED + 5), seed=1).astype(
                np.float32)).to(dev)
        score("mnist", mscorer, ref_m, xb, SEED,
              expected(K, reparam=1, kl=1, bernoulli=1),
              plain_elbo(cfg_m, model_m, d_m, xb, log_z_m, SEED,
                         plain_z=True))
    finally:
        out, _, secs["cli"] = finish_cli(child)

    # the CLI's artifacts: two written, the tempered scorer refused; its
    # scorer scores as the phase's own, its f32 sampler is the int8 one's
    # twin (the same shadow, seed and MALA steps)
    runs = [json.loads(ln) for ln in out.splitlines()
            if ln.startswith('{"export_argv"')]
    check([r["code"] for r in runs] == [0, 0, 1]
          and "temperature is sampler-only" in runs[2]["said"]
          and all(p.exists() for p in child["outs"].values()),
          f"apv-torch export: {out[-1500:]}")
    cli_scorer = load_exported(child["outs"]["scorer"])
    check(torch.equal(cli_scorer(x_all[:64], torch.tensor(SEED + 64)),
                      outs[64]), "the CLI's scorer artifact scores "
          "otherwise than the phase's")
    a32 = load_exported(child["outs"]["sampler"])(torch.tensor(SEED))
    size_ratio = paths["sampler_int8"].stat().st_size \
        / child["outs"]["sampler"].stat().st_size
    mad = float((a32 - a8).abs().mean())
    check(a8.shape == a32.shape
          and all(bool(((t >= 0) & (t <= 1)).all()) for t in (a32, a8))
          and size_ratio < 0.5 and mad < 0.05,
          f"int8 sampler vs the CLI's f32 one: int8 size ratio "
          f"{size_ratio}, mean |Δ| {mad}")
    emit("export", checkpoint=cfg.name, seconds=secs, ms=ms,
         max_abs_err=errs, bar=bars, launches_a_call=per_call,
         sampler_refine=SAMPLE_REFINE, int8_refine=CLI_REFINE,
         sampler_batch=int(a.shape[0]), int8_size_ratio=size_ratio,
         int8_mean_abs_diff=mad,
         bytes={**{k: p.stat().st_size for k, p in paths.items()},
                "cli_sampler": child["outs"]["sampler"].stat().st_size},
         cli_refusal=runs[2]["said"],
         tensorstore_importable=importlib.util.find_spec("tensorstore")
         is not None, launches=launches)
    return launches


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


def rmsnorm_phase(dev) -> dict:
    """The ResNet's fused norm modules (RMSNormAct, SiLU, bf16) at the
    train step's three stage shapes on channels_last activations, forward
    and backward through the op's autograd.Function with the counters
    zeroed around them: one launch each way a module, on the vector
    kernels; values and gradients held to autograd of the plain chain on
    the same NHWC views."""
    from apv_tpu_torch.models.common import RMSNormAct
    from apv_tpu_torch.ops import kernels as K
    rng = np.random.default_rng(SEED + 35)
    cases = []
    for _, rows, c in RMS_SHAPES[3:]:
        side = int(math.isqrt(rows // 256))
        x, w, dy = rms_inputs(rng, rows, c, torch.bfloat16, dev)
        m = RMSNormAct(c, torch.bfloat16, "silu").to(dev)
        with torch.no_grad():
            m.weight.copy_(w)
        to_nchw = lambda t, c=c, side=side: t.view(256, side, side, c) \
            .permute(0, 3, 1, 2)                            # channels_last
        cases.append((m, to_nchw(x), to_nchw(dy)))
    torch.cuda.synchronize()
    K.reset_launches()
    outs = []
    for m, x, dy in cases:
        xr = x.detach().requires_grad_(True)
        y = m(xr)
        outs.append((y.detach(), torch.autograd.grad(y, (xr, m.weight),
                                                     dy)))
    torch.cuda.synchronize()
    fwd_kernels = dict(K.rmsnorm_act_routes)
    bwd_kernels = dict(K.rmsnorm_act_bwd_routes)
    raw = {n: K.launches[n] for n in NORM_KERNELS}
    launches = path_counts(K)
    check(raw == dict.fromkeys(NORM_KERNELS, len(cases)) and launches
          == expected(K), f"rmsnorm_act launches {raw}, the rest {launches}")
    check(fwd_kernels == bwd_kernels == {"vector": len(cases), "scalar": 0},
          f"rmsnorm_act kernels {fwd_kernels}, backward {bwd_kernels}")
    errs = {}
    for (m, x, dy), (y, grads) in zip(cases, outs):
        check(y.is_contiguous(memory_format=torch.channels_last),
              "rmsnorm_act: the module's output is not channels_last")
        xp = x.detach().requires_grad_(True)
        wp = m.weight.detach().clone().requires_grad_(True)
        y_p = K.rmsnorm_act_plain(xp.permute(0, 2, 3, 1), wp, "silu")
        ref = torch.autograd.grad(y_p, (xp, wp), dy.permute(0, 2, 3, 1))
        fwd, _ = rms_fwd_err(K, x.permute(0, 2, 3, 1), wp.detach(), "silu",
                             y.permute(0, 2, 3, 1))
        grad = max(scale_rel(a, c) for a, c in zip(grads, ref))
        tag = f"{list(x.shape)} bfloat16"
        errs[tag] = {"fwd_ulps": fwd, "grad_scale_rel": grad}
        check(fwd <= RMS_FWD_TOL[torch.bfloat16] and grad
              <= RMS_GRAD_TOL[torch.bfloat16], f"rmsnorm_act {tag}: "
              f"forward {fwd} ulps, gradients {grad}")
        check(all(bool(torch.isfinite(t).all()) for t in (y, *grads)),
              f"rmsnorm_act {tag}: not finite")
    m, x, dy = cases[0]
    xr = x.detach().requires_grad_(True)
    fwd_bwd = cuda_ms(lambda: torch.autograd.grad(m(xr), (xr, m.weight),
                                                  dy), 50)
    emit("rmsnorm_act", launches=raw, fwd_kernels=fwd_kernels,
         bwd_kernels=bwd_kernels, errs=errs,
         tol_fwd="1 bf16 ulp from the chain at n or a neighbour of n",
         tol_grad="scale-relative 1e-2 (bf16), against autograd of the "
                  "plain chain", fwd_bwd_ms_bf16=fwd_bwd)
    return launches


PROBE_BENCH = {"n_iter": 10, "windows": 2, "reps": 2}


PRIOR_KL_RES = (1, 4, 8, 16, 32)      # VDVAE's decoder resolutions
PRIOR_KL_BATCH, PRIOR_KL_Z = 128, 16
# scale-relative: the kernel and the plain version compute each element
# with the same formula; expf, sincosf and logf differ from torch's by an
# ulp or two, and the KL's per-image sum runs in another order (measured
# 7e-8 to 2e-7 on an H100)
PRIOR_KL_TOL = 1e-5


def kernel_device_us(fn, name: str, iters: int = 20) -> float:
    """Mean device µs of the kernels whose name holds ``name`` over
    ``iters`` calls of ``fn``, from the profiler's device events (the
    kernel's launches one by one, where ``device_us`` reads the
    profiler's averages by key)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events()
             if e.device_type.name == "CUDA" and name in e.name]
    return sum(times) / len(times) if times else float("nan")


def _reparam_params(csrc: Path) -> int:
    """The parameters of ``apv_reparam`` in ``csrc``'s reparam.cu."""
    text = (csrc / "reparam.cu").read_text()
    head = text[text.index('extern "C" int apv_reparam('):]
    return head[:head.index(")")].count(",") + 1


def parent_bits(K, csrc: Path, dev) -> dict:
    """The N(0, I) reparam instances of this build against ``csrc``'s,
    bit for bit, on the same inputs and keys (passed by value; a build
    whose entry point also takes the key's device copy gets null)."""
    from apv_tpu_torch.ops import _build
    names = ("apv_reparam", "apv_reparam_bwd")
    sig = {n: _build.SIGNATURES[n] for n in names}
    if _reparam_params(csrc) < len(sig["apv_reparam"]):
        sig["apv_reparam"] = sig["apv_reparam"][:-2] + sig["apv_reparam"][-1:]
    libs = {"this": _build.library(), "parent": _build.load(
        _build.build(csrc, ROOT / ".bench_cache" / "parent_kernels"), sig)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = torch.Generator(device=dev).manual_seed(SEED + 41)
    out = {}
    for samples, kl in ((1, True), (5, False), (1, False)):
        b, z = 256, 128
        mean = torch.randn(b, z, generator=rng, device=dev)
        logvar = 0.5 * torch.randn(b, z, generator=rng, device=dev)
        g = torch.randn(samples, b, z, generator=rng, device=dev)
        g_kl = torch.randn(b, generator=rng, device=dev)
        got = {}
        for who, lib in libs.items():
            zs = torch.empty(samples, b, z, device=dev)
            kls = torch.empty(b, device=dev) if kl else None
            key = ((None,) if len(lib.apv_reparam.argtypes)
                   == len(_build.SIGNATURES["apv_reparam"]) else ())
            lib.apv_reparam(mean.data_ptr(), logvar.data_ptr(), zs.data_ptr(),
                            None if kls is None else kls.data_ptr(), samples,
                            b * z, z if kl else 0, 12345, 678, *key, stream)
            dm, dl = torch.empty_like(mean), torch.empty_like(mean)
            lib.apv_reparam_bwd(g.data_ptr(), zs.data_ptr(), mean.data_ptr(),
                                logvar.data_ptr() if kl else None,
                                g_kl.data_ptr() if kl else None,
                                dm.data_ptr(), dl.data_ptr(), samples, b * z,
                                z if kl else 0, stream)
            got[who] = [zs, dm, dl] + ([kls] if kl else [])
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got["this"],
                                                     got["parent"]))
        tag = f"S={samples}{' +kl' if kl else ''}"
        check(same, f"prior_kl: the N(0, I) reparam at {tag} differs from "
                    f"the parent's build")
        out[tag] = same
    return out


def prior_kl_phase(dev, parent_csrc: Path | None = None) -> dict:
    """Phase 24 (module docstring); returns the launch counts of one layer
    each way."""
    from apv_tpu_torch.ops import kernels as K
    cl = torch.channels_last
    rng = torch.Generator(device=dev).manual_seed(SEED + 40)
    b, zd = PRIOR_KL_BATCH, PRIOR_KL_Z
    rows, launches = {}, None
    for r in PRIOR_KL_RES:
        q = (0.5 * torch.randn(b, 2 * zd, r, r, generator=rng, device=dev)
             ).contiguous(memory_format=cl)
        p = (0.5 * torch.randn(b, 2 * zd, r, r, generator=rng, device=dev)
             ).contiguous(memory_format=cl)
        g = torch.randn(b, zd, r, r, generator=rng, device=dev).contiguous(
            memory_format=cl)
        g_kl = torch.randn(b, generator=rng, device=dev)
        torch.cuda.synchronize()
        K.reset_launches()
        z, kl = K.reparam_prior_cuda(q, p, 31, 41)
        grads = {case: K.reparam_prior_bwd_cuda(gz, z, q, p, gk)
                 for case, gz, gk in (("both", g, g_kl), ("z", g, None),
                                      ("kl", None, g_kl))}
        torch.cuda.synchronize()
        launches = dict(K.launches)
        check(launches == expected(K, reparam=1, reparam_bwd=3),
              f"prior_kl r={r}: launches {launches}")
        check(z.is_contiguous(memory_format=cl) and z.shape == (b, zd, r, r),
              f"prior_kl r={r}: z {tuple(z.shape)} {z.stride()}")
        zp, klp = K.reparam_prior_plain(q, p, 31, 41)
        errs = {"z": scale_rel(z, zp), "kl": scale_rel(kl, klp)}
        for case, gz, gk in (("both", g, g_kl), ("z", g, None),
                             ("kl", None, g_kl)):
            want = K.reparam_prior_bwd_plain(gz, z, q, p, gk)
            errs[f"dq_{case}"] = scale_rel(grads[case][0], want[0])
            errs[f"dp_{case}"] = scale_rel(grads[case][1], want[1])
        check(max(errs.values()) <= PRIOR_KL_TOL,
              f"prior_kl r={r}: {errs}")
        n = z.numel()
        fwd_us = kernel_device_us(
            lambda: K.reparam_prior_cuda(q, p, 31, 41), "reparam_samples")
        bwd_us = kernel_device_us(
            lambda: K.reparam_prior_bwd_cuda(g, z, q, p, g_kl),
            "reparam_bwd_sum")
        bw = mem_bw(torch.cuda.get_device_name(dev))
        rows[r] = {"errs": errs, "fwd_us": fwd_us, "bwd_us": bwd_us,
                   "fwd_bytes_share": 4 * (5 * n + b) / bw / (fwd_us * 1e-6),
                   "bwd_bytes_share": 4 * (10 * n + b) / bw
                   / (bwd_us * 1e-6)}
    bits = parent_bits(K, parent_csrc, dev) if parent_csrc else None
    emit("prior_kl", shapes=rows, parent_bits=bits)
    return launches


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

GRAPH_K = 10         # replayed steps held to eager ones
GRAPH_TIMED = 40     # steps timed each way


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (NaN included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def graph_batches(cfg, n: int, dev) -> list[dict]:
    """``n`` batches of ``cfg``'s train step on the card: uint8 levels, or
    bit-packed binarized rows for the packed configs."""
    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    b = cfg.train.batch_size
    h, w, c = cfg.model.image_shape
    if cfg.data.binarize and cfg.data.bit_pack:
        shape, key = (b, -(-h * w * c // 8)), "image_packed"
    else:
        shape, key = (b, h, w, c), "image"
    return [{key: torch.randint(0, 256, shape, generator=g, device=dev,
                                dtype=torch.uint8)} for _ in range(n)]


def graph_state(fns, cfg, start: int, plant=None):
    """A fresh state of ``cfg`` with its step and optimizer counts at
    ``start`` (moments zero); ``plant(state)`` alters it."""
    st = fns.init_fn(cfg.train.seed)
    st.step = start
    for o in (st.opt, st.d_opt):
        if o is not None:
            o.load_state_dict({"count": start, "mu": o.mu, "nu": o.nu})
    if plant is not None:
        plant(st)
    return st


def graph_pair(cfg, dev, start: int, k: int = GRAPH_K, plant=None) -> dict:
    """``k`` + 1 steps of ``cfg`` from one state at step ``start``, eagerly
    and through ``StepRunner`` (its first step eager, the others
    replayed), under deterministic cuDNN. Returns whether the states
    (every tensor, bit for bit, and the host counts), each step's metrics
    and the kernel wrappers' counters agree, and what differs."""
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.training.graph import StepRunner
    from apv_tpu_torch.training.step import make_train_fns
    fns = make_train_fns(cfg, device=dev)
    batches = graph_batches(cfg, k + 1, dev)
    runs = {}
    for way in ("eager", "replay"):
        st = graph_state(fns, cfg, start, plant)
        torch.cuda.synchronize()
        before = [dict(c) for c in K.COUNTERS]
        runner = StepRunner(fns, capture=way == "replay")
        ms = []
        with deterministic_cudnn():
            for b in batches:
                st, m = runner(st, b)
                ms.append({n: v.clone() for n, v in m.items()})
        torch.cuda.synchronize()
        launched = [{n: c[n] - b0.get(n, 0) for n in c}
                    for c, b0 in zip(K.COUNTERS, before)]
        runs[way] = (st, ms, launched, runner.eager)
        runner.close()
    (sa, ma, la, ea), (sb, mb, lb, eb) = runs["eager"], runs["replay"]
    counts = [(o, a) for o in ("opt", "d_opt") for a in ("count",
                                                         "mini_step")]

    def host(st):
        return [st.step] + [getattr(getattr(st, o), a) for o, a in counts
                            if getattr(st, o) is not None]
    tensors = [i for i, (x, y) in enumerate(zip(sa.tensors(), sb.tensors()))
               if not same_bits(x, y)]
    metrics = sorted({n for x, y in zip(ma, mb) for n in x
                      if n not in y or not same_bits(x[n], y[n])})
    out = {"tensors": len(sa.tensors()), "tensors_differ": tensors,
           "host_counts": [host(sa), host(sb)], "metrics_differ": metrics,
           "launches": la[0], "launches_equal": la == lb,
           "eager_steps": [ea, eb],
           "skipped": [float(st.opt.skipped) for st in (sa, sb)]
           if hasattr(sa.opt, "skipped") else None}
    out["bits_equal"] = (not tensors and not metrics and la == lb
                         and host(sa) == host(sb) and ea == k + 1
                         and eb == 1)
    return out


def graph_timing(cfg, dev, start: int, steps: int = GRAPH_TIMED) -> dict:
    """``steps`` steps of ``cfg`` each way after a warm-up, timed on the
    host clock to the device's end: steps a second eagerly and by replay,
    the peak of device memory each way, and the capture's wall (from its
    start to the end of its device work)."""
    from apv_tpu_torch.training.graph import StepRunner
    from apv_tpu_torch.training.step import make_train_fns
    fns = make_train_fns(cfg, device=dev)
    batches = graph_batches(cfg, 4, dev)
    out = {}
    for way in ("eager", "replay"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        st = graph_state(fns, cfg, start)
        runner = StepRunner(fns, capture=way == "replay")
        st, _ = runner(st, batches[0])             # eager either way
        if way == "replay":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner._capture(st, batches[1])
            torch.cuda.synchronize()
            out["capture_s"] = time.perf_counter() - t0
        for i in range(3):
            st, _ = runner(st, batches[i % 4])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            st, m = runner(st, batches[i % 4])
        torch.cuda.synchronize()
        out[f"{way}_steps_s"] = steps / (time.perf_counter() - t0)
        out[f"{way}_memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            dev)
        check(math.isfinite(float(m["loss"])),
              f"graph_step: a {way} step's loss is {float(m['loss'])}")
        runner.close()
        del st, m, runner
    out["replay_over_eager"] = out["replay_steps_s"] / out["eager_steps_s"]
    return out


def graph_step_phase(dev) -> dict:
    """Phase 25 (module docstring); returns the launch counts of one
    flagship step."""
    from apv_tpu_torch import apply_overrides, get_preset
    rows, launches = {}, None
    for name, start in (("cifar_advprior_resnet", 10),
                        ("vdvae_cifar10", 10)):
        cfg = apply_overrides(get_preset(name), ["train.steps=100000"])
        pair = graph_pair(cfg, dev, start)
        check(pair["bits_equal"], f"graph_step {name}: replayed steps "
              f"differ from eager ones: {pair}")
        rows[name] = {"pair": pair, **graph_timing(cfg, dev, start)}
        if launches is None:
            launches = {n: v // (GRAPH_K + 1)
                        for n, v in pair["launches"].items()}
        gc.collect()
        torch.cuda.empty_cache()
    emit("graph_step", cases=rows)
    return launches


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="also profile one IWAE batch of each family, 16 "
                         "train steps of each family, of both trained "
                         "priors, of the IWAE objective, the knobs and "
                         "the mixture head; write tables here")
    ap.add_argument("--quality-gate", action="store_true",
                    help="also run the 3k-step CIFAR gate and IWAE k=100 "
                         "on 512 test images (a few minutes)")
    ap.add_argument("--prior-kl-only", action="store_true",
                    help="phase 24 alone, after the build")
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="with --prior-kl-only: hold the N(0, I) reparam "
                         "instances to the bits of this ops/csrc's build")
    ap.add_argument("--graph-step-only", action="store_true",
                    help="phase 25 alone, after the build")
    ap.add_argument("--biadv-seeds", type=int, default=0, metavar="N",
                    help="instead of the paths: train the biadversarial "
                         "flagship as phase 18 does and run its gradient "
                         "check at N seeds of its inputs")
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
    if args.biadv_seeds:
        return biadv_seeds(args.biadv_seeds, dev)
    if args.prior_kl_only:
        prior_kl_phase(dev, args.parent_csrc)
        emit("ok", ok=True)
        return 0
    if args.graph_step_only:
        graph_step_phase(dev)
        emit("ok", ok=True)
        return 0

    # 2. kernels
    with torch.inference_mode():
        kres = kernel_checks(K, card, dev)
    krng = np.random.default_rng(SEED + 30)
    kres.update(gn_kernel_checks(K, card, krng, dev))
    kres.update(conv_kernel_checks(K, card, krng, dev))
    kres.update(rms_kernel_checks(K, card, np.random.default_rng(SEED + 34),
                                  dev))
    for name, r in kres.items():
        emit("kernel", name=name, **{"library_ms": None, **r})

    # 3-4. scorer and IWAE of the CIFAR flagship at full width
    count_shapes(K)
    count_norms(K)
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
        path_launches["cifar_train"], state, cfg3, flagship_s = \
            cifar_train_phase(dev, tmp)
        path_launches["cifar_ckpt"] = cifar_ckpt_phase(cfg3, state, tmp, dev)
        del state
        # 10-13. the fused op, the conv probe, then config 5 on the
        # step-48 checkpoint
        path_launches["groupnorm_gelu"] = groupnorm_phase(dev)
        path_launches["rmsnorm_act"] = rmsnorm_phase(dev)
        path_launches["conv3x3"] = conv_phase(dev)
        path_launches["prior_kl"] = prior_kl_phase(dev)
        path_launches["graph_step"] = graph_step_phase(dev)
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
        # (23.) phase 23's children start here, beside phases 14-22
        dist = start_distributed(tmp)
        path_launches["gb_train"], cfg_gb = prior_phase(
            "gb_train", "cifar_gb", arrays, tmp, dev)
        path_launches["flow_train"], cfg_flow = prior_phase(
            "flow_train", "cifar_flow", arrays, tmp, dev)
        path_launches["iwae_train"], cfg5 = iwae_train_phase(arrays, tmp,
                                                             dev)
        # 17-18. the CLI as a user runs it, then the biadversarial flagship
        path_launches["front_door"] = front_door_phase(dev)
        path_launches["biadv_train"], cfg6 = biadv_train_phase(arrays, tmp,
                                                               dev)
        # 19-21. the training knobs, the mixture head, the visualizer on
        # the knobs' EMA checkpoint
        path_launches["knobs_train"], cfg7 = knobs_train_phase(
            arrays, tmp, dev, flagship_s)
        # (22.) the CLI children of phases 21-22 start here, beside 20-21
        child = start_visualize_cli(cfg7, tmp)
        exporter = start_export_cli(cfg7, tmp)
        try:
            path_launches["mix_train"], cfg8, mix_ms = mix_train_phase(
                arrays, tmp, dev, flagship_s)
            path_launches["visualize"] = visualize_phase(cfg7, tmp, dev,
                                                         child)
            # 22. the serving artifacts of the knobs' checkpoint
            path_launches["export"] = export_phase(cfg7, tmp, dev, exporter)
            # 23. data parallelism on the one card
            K.reset_launches()
            path_launches["distributed"] = distributed_phase(tmp, dev, dist)
        finally:
            for c in (child, exporter):
                if c["proc"].poll() is None:
                    c["proc"].kill()
                    c["proc"].wait()
            stop_distributed(dist)
        if args.profile is not None:
            profile_train(args.profile, cfg_gb, dev, tag="gb_train")
            profile_train(args.profile, cfg_flow, dev, tag="flow_train")
            profile_train(args.profile, cfg5, dev, tag="iwae_train")
            profile_train(args.profile, cfg6, dev, tag="biadv_train")
            profile_train(args.profile, cfg7, dev, tag="knobs_train")
            busy_us = profile_train(args.profile, cfg8, dev, tag="mix_train")
            # the op timed in phase 20, outside the profiler (which slows
            # back-to-back launches), over a step's device time
            emit("mix_share", steps=16, mix_fwd_bwd_ms=mix_ms,
                 step_device_ms=busy_us / 1e3 / 16,
                 share_of_step_device_time=16 * mix_ms / (busy_us / 1e3))

    total = {n: sum(pl[n] for pl in path_launches.values())
             for n in K.launches}
    total.update({n: NORM_TOTAL[n] for n in NORM_KERNELS})
    for name, n in total.items():
        check((n > 0) != (name in OFF_PATH), f"{name}: {n} launches on "
              f"the main paths, {'none' if name in OFF_PATH else 'some'} "
              "expected")
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
                  tag: str = "train") -> float:
    """16 steady train steps of ``cfg`` on resident data (packed digits, or
    uint8 CIFAR-shaped levels for the dequantized configs), as the loop
    runs them (without its logger), after 8 warm-up steps. Returns their
    device µs (``profile_window``)."""
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
    return profile_window(out_dir, tag, lambda: run(8, 8 + steps),
                          steps=steps)


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
                   **extra) -> float:
    """Device time by kernel over ``fn()`` (torch.profiler), its wall time
    and the device's idle share; with ``with_floor``, also the device time
    a launch of the one-element ``neg_`` that ``fn`` interleaves with its
    kernels (``floor_us``). Returns the window's device µs."""
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
    return total_us


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
