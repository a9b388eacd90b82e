#!/usr/bin/env python3
"""Drive the PyTorch port's scoring path on one CUDA card and check it.

    python3 chip_smoke.py                      # needs one CUDA card
    python3 chip_smoke.py --profile DIR        # also writes a profiler table

Phases, one JSON line each:
  1. device: the card (nvidia-smi name and power limit), torch and CUDA
     versions, and the nvcc build of the kernels in apv_tpu_torch/ops/csrc.
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the shapes the scoring path gives it, with its time, the
     plain version's time and the least time the card could take.
  3. scorer: the per-sample ELBO scorer of cifar_advprior_resnet at full
     width (batch 64, bf16 compute, random seeded weights) through the
     kernels, held to the same ELBO recomputed with the plain ops on the
     kernel path's z.
  4. iwae: the iwae_eval preset's k=1000 IWAE over one batch of 64 images
     to bits/dim, with the log-partition estimate of the learned prior.
Each path runs once with the launch counters zeroed just before it and
read just after; a kernel of the path that did not launch fails the run.
Then a {"kernels": [...]} line, the nvidia-smi line and, last, the
{"ok": true, ...} line. Any failed check exits nonzero without that line.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
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

# Per-element operation counts for the bounds, each transcendental counted
# as one operation: disc_logistic ~8 transcendentals + ~22 adds, multiplies
# and compares; reparam 10 Philox rounds of ~10 integer ops per 4 elements,
# Box-Muller and the affine; kl 2 + 4.
OPS_PER_ELEM = {"disc_logistic": 30, "reparam": 33, "kl": 6}

REPLACES = {
    "disc_logistic": "apv_tpu/ops/kernels.py:211",
    "kl": "apv_tpu/ops/kernels.py:111",
    "reparam": "apv_tpu/ops/kernels.py:305",
}


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
    return results


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="also profile one IWAE batch; write tables here")
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
    from apv_tpu_torch import (build_model, evaluate_nll, get_preset,
                               make_latent_d, make_scorer)
    from apv_tpu_torch import ops
    from apv_tpu_torch.eval.iwae_eval import estimate_log_partition
    from apv_tpu_torch.ops import _build
    from apv_tpu_torch.ops import kernels as K
    from apv_tpu_torch.training.losses import \
        decoder_output_to_likelihood_params

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
        emit("kernel", name=name, **r)

    # 3. scorer, preset cifar_advprior_resnet at full width
    cfg = get_preset("cifar_advprior_resnet")
    model = build_model(cfg.model, device=dev, seed=SEED)
    d = make_latent_d(cfg.adversarial, cfg.model.z_dim, device=dev,
                      seed=SEED + 1)
    images = np.random.default_rng(SEED + 2).integers(
        0, 256, size=(BATCH, 32, 32, 3), dtype=np.uint8)
    x = torch.from_numpy(images.astype(np.float32) / 255.0).to(dev)
    with torch.inference_mode():
        log_z, log_z_se = estimate_log_partition(
            d, cfg.model.z_dim, seed=SEED + 17, with_se=True, device=dev)
    log_z = float(log_z)
    scorer = make_scorer(cfg, model, d, log_z, device=dev)
    gen = lambda s: torch.Generator().manual_seed(s)       # noqa: E731
    scorer(x, generator=gen(99))                            # warm up
    torch.cuda.synchronize()

    K.reset_launches()
    elbo = scorer(x, generator=gen(SEED))
    torch.cuda.synchronize()
    scorer_launches = dict(K.launches)
    check(scorer_launches == {"reparam": 1, "kl": 1, "disc_logistic": 1},
          f"scorer launches {scorer_launches}")
    check(elbo.shape == (BATCH,) and bool(torch.isfinite(elbo).all()),
          "scorer: ELBO not finite or of the wrong shape")

    with torch.inference_mode():        # plain ops on the kernel path's z
        mean, logvar = model.encode(x * 2.0 - 1.0)
        z = ops.reparam_sample(mean, logvar, generator=gen(SEED))
        m, ls = decoder_output_to_likelihood_params(
            model.decode(z), cfg.model.likelihood, 3)
        elbo_plain = (K.disc_logistic_plain(x, m, ls) - K.kl_plain(mean, logvar)
                      + d(z) - log_z)
    err = float((elbo - elbo_plain).abs().max())
    # the same decoder output, kernel vs plain sums: as phase 2's bars
    tol = 5e-2 + 1e-5 * float(elbo_plain.abs().max())
    check(err <= tol, f"scorer: max |ELBO - plain ELBO| {err} > {tol}")
    iters = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        scorer(x, generator=gen(i))
    torch.cuda.synchronize()
    scorer_s = (time.perf_counter() - t0) / iters
    elbo_np = elbo.double().cpu().numpy()
    emit("scorer", preset=cfg.name, batch=BATCH, launches=scorer_launches,
         elbo_mean=float(elbo_np.mean()), elbo_std=float(elbo_np.std()),
         max_abs_err_vs_plain=err, tol=tol, log_partition=log_z,
         log_partition_se=float(log_z_se), ms_per_batch=scorer_s * 1e3,
         images_per_s=BATCH / scorer_s)

    # 4. IWAE k=1000, preset iwae_eval
    cfg4 = get_preset("iwae_eval")
    k, chunk = cfg4.eval.iwae_k, cfg4.eval.iwae_chunk
    check((k, chunk) == (1000, 25), f"iwae_eval preset has k={k}, "
          f"chunk={chunk}")
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = evaluate_nll(cfg4, model, d, images, k=k, chunk=chunk,
                       batch_size=BATCH, seed=SEED, per_sample=True,
                       device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iwae_launches = dict(K.launches)
    n_chunks = k // chunk
    check(iwae_launches == {"reparam": n_chunks, "kl": 0,
                            "disc_logistic": n_chunks},
          f"iwae launches {iwae_launches}")
    per = np.asarray(res.pop("per_sample"))
    check(per.shape == (BATCH,) and np.all(np.isfinite(per))
          and math.isfinite(res["bits_per_dim"]), "iwae: not finite")
    margin = elbo_np.std(ddof=1) / math.sqrt(BATCH)
    check(per.mean() >= elbo_np.mean() - margin,
          f"iwae mean {per.mean()} below ELBO mean {elbo_np.mean()} - "
          f"{margin}")
    t0 = time.perf_counter()
    evaluate_nll(cfg4, model, d, images, k=k, chunk=chunk, batch_size=BATCH,
                 seed=SEED + 1, device=dev)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    emit("iwae", preset=cfg4.name, k=k, chunk=chunk, batch=BATCH,
         launches=iwae_launches, **res, elbo_mean=float(elbo_np.mean()),
         iwae_mean=float(per.mean()), wall_s_first=wall, wall_s=wall2,
         images_per_s=BATCH / wall2)

    if args.profile is not None:
        profile_iwae(args.profile, cfg4, model, d, images, k, chunk)

    total = {n: scorer_launches[n] + iwae_launches[n] for n in K.launches}
    for name, n in total.items():
        check(n > 0, f"{name} was not launched on the main path")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"apv_tpu_torch/ops/csrc/{name}.cu",
         "replaces": REPLACES[name], "launches": total[name],
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"],
         "bound_ms": kres[name]["bound_ms"],
         "bound_by": kres[name]["bound_by"], "library_ms": None}
        for name in ("reparam", "kl", "disc_logistic")]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profile_iwae(out_dir: Path, cfg, model, d, images, k, chunk) -> None:
    """Device time by kernel over one IWAE batch (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from apv_tpu_torch import evaluate_nll
    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate_nll(cfg, model, d, images, k=k, chunk=chunk,
                     batch_size=BATCH, seed=SEED + 2, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=60)
    (out_dir / "iwae_profile.txt").write_text(table)

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
    emit("profile", wall_s=wall, device_busy_s=total_us / 1e6,
         device_idle_share=max(0.0, 1.0 - total_us / 1e6 / wall),
         top=[{"name": e.key[:80], "device_ms": dev_us(e) / 1e3,
               "calls": e.count} for e in top])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
