#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py                      # needs one CUDA card
    python3 chip_smoke.py --profile DIR        # also writes profiler tables

Phases, one JSON line each:
  1. device: the card (nvidia-smi name and power limit), torch and CUDA
     versions, and the nvcc build of the kernels in apv_tpu_torch/ops/csrc.
  2. kernel: each hand-written kernel (forward and backward) against its
     plain PyTorch version on the card, at the shapes the paths give it,
     with its time, the plain version's time and the least time the card
     could take.
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
Each path runs once with the launch counters zeroed just before it and
read just after; a kernel of the paths that did not launch fails the run.
Then a {"kernels": [...]} line, the nvidia-smi line and, last, the
{"ok": true, ...} line. Any failed check exits nonzero without that line.
"""

from __future__ import annotations

import argparse
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

# Per-element operation counts for the bounds, each transcendental counted
# as one operation: disc_logistic ~8 transcendentals + ~22 adds, multiplies
# and compares; reparam 10 Philox rounds of ~10 integer ops per 4 elements,
# Box-Muller and the affine; kl 2 + 4; bernoulli exp, log1p, max, abs, a
# multiply and two adds; bernoulli_bwd exp, add, divide, subtract,
# multiply; kl_bwd exp, subtract, three multiplies; reparam_bwd per sample
# two adds, a subtract and two multiplies.
OPS_PER_ELEM = {"disc_logistic": 30, "reparam": 33, "kl": 6, "bernoulli": 7,
                "bernoulli_bwd": 5, "kl_bwd": 5, "reparam_bwd": 5}

REPLACES = {
    "reparam": "apv_tpu/ops/kernels.py:305",
    "kl": "apv_tpu/ops/kernels.py:111",
    "disc_logistic": "apv_tpu/ops/kernels.py:211",
    "bernoulli": "apv_tpu/ops/kernels.py:149",
    "reparam_bwd": "apv_tpu/ops/kernels.py:348",
    "kl_bwd": "apv_tpu/ops/kernels.py:121",
    "bernoulli_bwd": "apv_tpu/ops/kernels.py:159",
}
# each kernel's __global__ function, to find it in a profile
KERNEL_FNS = {"reparam": "reparam_samples", "kl": "kl_rows",
              "disc_logistic": "disc_logistic_rows",
              "bernoulli": "bernoulli_rows", "reparam_bwd": "reparam_bwd_sum",
              "kl_bwd": "kl_bwd_rows", "bernoulli_bwd": "bernoulli_bwd_rows"}
SOURCES = {name: f"apv_tpu_torch/ops/csrc/{name.removesuffix('_bwd')}.cu"
           for name in REPLACES}

TRAIN_STEPS = 48           # six calls of the preset's steps_per_call=8
N_TRAIN_IMAGES = 60_000    # MNIST's train split


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

def kernel_checks(K, card: str, dev) -> dict:
    rng = np.random.default_rng(SEED)
    results = {}
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa

    # disc_logistic at the IWAE chunk's [chunk*B, H*W*C] = [1600, 3072]
    rows, event = 25 * BATCH, 3072
    x = rng.integers(0, 256, size=(rows, event)) / 255.0
    x[0, :256] = np.arange(256) / 255.0          # every level, edges too
    mean = rng.uniform(-0.2, 1.2, size=(rows, event))
    ls = rng.uniform(-7.0, 0.0, size=(rows, event))
    ls[1] = -7.0                                  # the decoder's floor
    x, mean, ls = (cuda(a.astype(np.float32)) for a in (x, mean, ls))
    got = K.disc_logistic_cuda(x, mean, ls)
    want = K.disc_logistic_plain(x, mean, ls)
    err = float((got - want).abs().max())
    # f32 sums of 3072 terms in another order, plus an ulp or two per
    # transcendental: 1e-2 + 1e-5 x |sum|
    tol = 1e-2 + 1e-5 * float(want.abs().max())
    check(err <= tol, f"disc_logistic: max |kernel - plain| {err} > {tol}")
    # a row length that is not a multiple of 4 takes the scalar tail
    xo, mo, so = (cuda(rng.uniform(lo, hi, size=(7, 3073)).astype(np.float32))
                  for lo, hi in ((0, 1), (-0.2, 1.2), (-7, 0)))
    xo = torch.round(xo * 255) / 255
    err_tail = float((K.disc_logistic_cuda(xo, mo, so)
                      - K.disc_logistic_plain(xo, mo, so)).abs().max())
    check(err_tail <= tol, f"disc_logistic tail: {err_tail} > {tol}")
    results["disc_logistic"] = {
        "shape": [rows, event], "max_abs_err": err, "tol": tol,
        "max_abs_err_odd_length": err_tail,
        "ms": cuda_ms(lambda: K.disc_logistic_cuda(x, mean, ls), 200),
        "plain_ms": cuda_ms(lambda: K.disc_logistic_plain(x, mean, ls), 20),
        **bound("disc_logistic", card, 4 * (3 * rows * event + rows),
                rows * event)}

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

    # reparam from [64, 128] to the IWAE chunk's [25, 64, 128]
    seed, offset = 0x0123456789ABCDEF, 42
    got = K.reparam_cuda(m, lv, 25, seed, offset)
    want = K.reparam_plain(m, lv, 25, seed, offset)
    rel = float(((got - want).abs() / (1.0 + want.abs())).max())
    # the same Philox words and f32 Box-Muller; libm ulps only
    check(rel <= 1e-5, f"reparam: max |kernel - plain|/(1+|z|) {rel} > 1e-5")
    check(torch.equal(got, K.reparam_cuda(m, lv, 25, seed, offset)),
          "reparam: the same (seed, offset) gave a different z")

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
    results["reparam"] = {
        "shape": [25, BATCH, 128], "max_abs_err":
            float((got - want).abs().max()), "max_rel_err": rel,
        "moments_8.2M": mom, "correlations": corrs,
        "ms": cuda_ms(lambda: K.reparam_cuda(m, lv, 25, seed, offset), 500),
        "plain_ms": cuda_ms(lambda: K.reparam_plain(m, lv, 25, seed, offset),
                            50),
        **bound("reparam", card, 4 * (2 * BATCH * 128 + 25 * BATCH * 128),
                25 * BATCH * 128)}
    results.update(mnist_kernel_checks(K, card, rng, cuda))
    return results


def ulp_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (1 + |want|), elementwise."""
    return float(((got - want).abs() / (1.0 + want.abs())).max())


def mnist_kernel_checks(K, card: str, rng, cuda) -> dict:
    """The MNIST training path's kernels: bernoulli at the IWAE chunk, the
    train step and an odd row length, and the three backward kernels held
    to their plain formulas elementwise at 1e-6·(1 + |ref|): the same f32
    operations, libm ulps apart."""
    results = {}
    z_dim, tb, event = 40, 256, 784

    def bern_inputs(rows, ev):
        x = (rng.random((rows, ev)) < 0.2).astype(np.float32)
        logits = (3.0 * rng.normal(size=(rows, ev))).astype(np.float32)
        logits[0, :3] = (0.0, 60.0, -60.0)       # softplus' far branches
        return cuda(x), cuda(logits)

    errs, tols = {}, {}
    for tag, (rows, ev) in (("iwae", (50 * BATCH, event)),
                            ("train", (tb, event)), ("odd", (7, event + 1))):
        x, logits = bern_inputs(rows, ev)
        got, want = K.bernoulli_cuda(x, logits), K.bernoulli_plain(x, logits)
        errs[tag] = float((got - want).abs().max())
        # f32 sums of 784 terms in another order
        tols[tag] = 1e-4 + 1e-6 * float(want.abs().max())
        check(errs[tag] <= tols[tag], f"bernoulli {tag}: max |kernel - "
              f"plain| {errs[tag]} > {tols[tag]}")
        if tag == "iwae":
            xi, li = x, logits
        elif tag == "train":
            xt, lt = x, logits
    rows = 50 * BATCH
    results["bernoulli"] = {
        "shape": [rows, event], "max_abs_err": errs["iwae"],
        "tol": tols["iwae"], "max_abs_err_train": errs["train"],
        "max_abs_err_odd_length": errs["odd"],
        "ms": cuda_ms(lambda: K.bernoulli_cuda(xi, li), 500),
        "plain_ms": cuda_ms(lambda: K.bernoulli_plain(xi, li), 50),
        "ms_train_shape": cuda_ms(lambda: K.bernoulli_cuda(xt, lt), 500),
        **bound("bernoulli", card, 4 * (2 * rows * event + rows),
                rows * event)}

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
    results["bernoulli_bwd"] = {
        "shape": [tb, event], "max_abs_err": float((dl - dl_ref).abs().max()),
        "max_rel_err": err, "max_rel_err_odd_length_with_dx": err_odd,
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
    gz, z, mean = res[1][2]
    n = tb * z_dim
    results["reparam_bwd"] = {
        "shape": [1, tb, z_dim], "max_abs_err": res[1][1],
        "max_rel_err": res[1][0], "max_rel_err_s50": res[50][0],
        "ms": cuda_ms(lambda: K.reparam_bwd_cuda(gz, z, mean), 500),
        "plain_ms": cuda_ms(lambda: K.reparam_bwd_plain(gz, z, mean), 200),
        **bound("reparam_bwd", card, 4 * (2 * n + n + 2 * n), n)}
    return results


def bounds_to_port(card: str) -> dict:
    """The least time of the TPU kernels still to port, at the shapes
    below, by the same rule as ``bound``: bytes (each input read
    once, each output written once) over the memory rate, or operations
    over the peak for their type, whichever is larger. No kernel runs.

    * groupnorm_gelu (apv_tpu/ops/groupnorm.py:116) on the first stage of a
      norm=group flagship: bf16 x [256, 32, 32, 64] in and out; ~13
      operations per element (two for the statistics, three to normalize
      and scale, ~8 for tanh-GELU) on the f32 units.
    * pallas_conv (scripts/conv_microbench.py:67) at the probe's three
      shapes (B, H, W, Cin, Cout): bf16 x and w in, f32 out, 2·9·Cin
      operations per output element on the bf16 tensor cores.
    """
    bw = mem_bw(card)
    out = {}
    n = 256 * 32 * 32 * 64
    t_b, t_o = 2 * 2 * n / bw, 13 * n / F32_OPS
    out["groupnorm_gelu [256,32,32,64] bf16"] = {
        "bound_ms": max(t_b, t_o) * 1e3,
        "bound_by": "bytes" if t_b >= t_o else "operations"}
    for b, h, w, cin, cout in ((256, 32, 32, 64, 64), (256, 16, 16, 128, 128),
                               (256, 8, 8, 256, 256)):
        outs = b * h * w * cout
        nbytes = 2 * b * h * w * cin + 2 * 9 * cin * cout + 4 * outs
        t_b, t_o = nbytes / bw, 2 * 9 * cin * outs / BF16_TENSOR_OPS
        out[f"pallas_conv {[b, h, w, cin, cout]}"] = {
            "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}
    return out


# ---------------------------------------------------------------------------
# phases 3-4 and 6-7: the scorer and IWAE k=1000 on one batch
# ---------------------------------------------------------------------------

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
    launches = dict(K.launches)
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


def iwae_phase(phase, cfg, model, d, images, elbo_np, chunk_want, dev):
    """evaluate_nll over one batch at k=1000 with the counters zeroed
    around it; IWAE mean >= ELBO mean - SE; then a timed repeat."""
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
    launches = dict(K.launches)
    recon = "bernoulli" if cfg.model.likelihood == "bernoulli" \
        else "disc_logistic"
    check(launches == expected(K, reparam=k // chunk, **{recon: k // chunk}),
          f"{phase} launches {launches}")
    per = np.asarray(res.pop("per_sample"))
    check(per.shape == (batch,) and np.all(np.isfinite(per))
          and math.isfinite(res["bits_per_dim"]), f"{phase}: not finite")
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


def grad_check(cfg, state, x, dev) -> dict:
    """One G step's gradients through the kernels against the same step
    through the plain ops, on the same noise: the plain Philox stream
    reproduces the kernel's ε. f32 compute and deterministic cuDNN, so the
    two differ only by the kernels' rounding (in bf16 a z one ulp apart
    can round to another bf16 value and move every later layer)."""
    from apv_tpu_torch import build_model
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.training.step import g_objective
    torch.backends.cudnn.deterministic = True
    try:
        m32 = build_model(cfg.model, dtype=torch.float32, device=dev)
        m32.load_state_dict(state.model.state_dict())
        params = list(m32.parameters())
        beta = 1.0
        loss_k, _, _ = g_objective(cfg, m32, state.d, x, x, beta,
                                   generator=gen(SEED + 5))
        grads_k = torch.autograd.grad(loss_k, params)

        mean, logvar = m32.encode(x)
        z = K.reparam_plain(mean, logvar, 1, *K.draw_key(gen(SEED + 5)))[0]
        recon = K.bernoulli_plain(x, m32.decode(z))
        adv = cfg.adversarial.weight * beta * state.d(z)
        loss_p = -((recon + adv).mean() - beta * K.kl_plain(mean,
                                                            logvar).mean())
        grads_p = torch.autograd.grad(loss_p, params)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(grads_k, grads_p))
    check(rel <= 1e-3, f"train: G gradients kernels vs plain, "
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
    launches = dict(K.launches)
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
    grads = grad_check(cfg, state, x, dev)

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
# main
# ---------------------------------------------------------------------------

def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="also profile one IWAE batch of each family and "
                         "16 MNIST train steps; write tables here")
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
    for name, r in kres.items():
        emit("kernel", name=name, library_ms=None, **r)
    emit("to_port", bounds=bounds_to_port(card))

    # 3-4. scorer and IWAE of the CIFAR flagship at full width
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

    total = {n: sum(pl[n] for pl in path_launches.values())
             for n in K.launches}
    for name, n in total.items():
        check(n > 0, f"{name} was not launched on the main paths")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": total[name],
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"],
         "bound_ms": kres[name]["bound_ms"],
         "bound_by": kres[name]["bound_by"], "library_ms": None}
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


def profile_train(out_dir: Path, cfg, dev, steps: int = 16) -> None:
    """16 steady train steps of ``cfg`` on resident packed data, as the
    loop runs them (without its logger), after 8 warm-up steps."""
    from apv_tpu_torch.data.preprocess import pack_bits, static_binarize
    from apv_tpu_torch.training.step import make_train_fns
    fns = make_train_fns(cfg, device=dev)
    state = fns.init_fn(cfg.train.seed)
    packed = pack_bits(static_binarize(synthetic_digits(4096, SEED + 6)))
    data = torch.from_numpy(packed).to(dev)
    idx = torch.randint(0, len(packed), (steps + 8, cfg.train.batch_size),
                        generator=gen(SEED)).to(dev)

    def run(lo, hi):
        for i in range(lo, hi):
            fns.train_step(state, {"image_packed": data.index_select(
                0, idx[i])})
        torch.cuda.synchronize()

    run(0, 8)
    profile_window(out_dir, "train", lambda: run(8, 8 + steps),
                   steps=steps)


def profile_window(out_dir: Path, tag: str, fn, **extra) -> None:
    """Device time by kernel over ``fn()`` (torch.profiler), its wall time
    and the device's idle share."""
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
    ours = {name: {"device_us_per_call": dev_us(e) / e.count,
                   "calls": e.count}
            for e in events for name, fn in KERNEL_FNS.items()
            if f"::{fn}(" in e.key}
    emit("profile", window=tag, wall_s=wall, device_busy_s=total_us / 1e6,
         device_idle_share=max(0.0, 1.0 - total_us / 1e6 / wall),
         top=[{"name": e.key[:80], "device_ms": dev_us(e) / 1e3,
               "calls": e.count} for e in top], kernels=ours, **extra)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
