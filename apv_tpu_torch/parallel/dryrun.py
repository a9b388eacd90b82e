"""Multi-process dry run of the data-parallel paths (counterpart of
``dryrun_multichip`` in the reference's driver entry points).

``spawn(n, "module:function", *args)`` runs ``function(*args)`` in n fresh
processes that have joined one group (``parallel/multihost.init_group``)
through a ``file://`` store in a temporary directory, so no port can
collide; a rank that fails fails the call, and the others are stopped.

``dryrun_multiproc(n)`` spawns n ranks and runs, at the reference's tiny flagship (``cifar_advprior_resnet`` at
z 8, widths [8, 16, 16], one block a stage, batch 16), one step of each
path: through ``train_loop`` the plain loop, ``train.steps_per_call=2``
and ``data.device_resident``; through the step the biadversarial pair,
the IWAE/DReG objective (k=3), the spectrally normalized D, the Gaussian
base and the flow prior. Each rank then holds its replica to every
other's, bit for bit. With n ≥ 2 the k-sharded IWAE runs on an
(n/2, 2) grid under the model's prior and under an ex-post flow.

The ranks run on the card unless the device named is the CPU (gloo
there), one card a rank over NCCL; ranks that share a card need
``backend="gloo"`` (NCCL refuses two ranks on one GPU):

    python -m apv_tpu_torch.parallel.dryrun 2 --device cpu
    python -m apv_tpu_torch.parallel.dryrun 2 --backend gloo   # one card
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

_ROOT = Path(__file__).resolve().parents[2]


def spawn(n: int, target: str, *args, device=None,
          backend: str | None = None, paths: tuple[str, ...] = (),
          timeout: float = 600.0) -> list[str]:
    """Run ``target`` (``"module:function"``) with the JSON-able ``args``
    in ``n`` ranks of a new group on ``device`` (``None``: the card, as
    ``resolve_device``; NCCL then needs a card a rank, ``backend="gloo"``
    lets ranks share one); ``paths`` go on the ranks' ``PYTHONPATH``
    (after this checkout). Returns each rank's output; raises
    ``RuntimeError`` with the failing ranks' output."""
    return finish_ranks(start_ranks(n, target, *args, device=device,
                                    backend=backend, paths=paths),
                        timeout)


def start_ranks(n: int, target: str, *args, device=None,
                backend: str | None = None,
                paths: tuple[str, ...] = ()) -> dict:
    """``spawn``'s ranks started, not waited for (``finish_ranks``)."""
    from apv_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and backend in (None, "nccl") \
            and n > torch.cuda.device_count():
        raise ValueError(
            f"{n} NCCL ranks need {n} cards, {torch.cuda.device_count()} "
            "found; pass backend='gloo' for ranks that share a card")
    full = dict(os.environ)
    full["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT), *paths] + ([full["PYTHONPATH"]]
                                if full.get("PYTHONPATH") else []))
    tmp = tempfile.TemporaryDirectory()
    store = Path(tmp.name) / "store"
    procs, outs = [], []
    for rank in range(n):
        out = Path(tmp.name) / f"rank{rank}.out"
        outs.append(out)
        cmd = [sys.executable, "-m", "apv_tpu_torch.parallel.dryrun",
               "--rank", str(rank), "--world", str(n),
               "--init", f"file://{store}", "--device", str(dev),
               "--backend", backend or "", "--target", target,
               "--args", json.dumps(list(args))]
        with open(out, "w") as fo:
            procs.append(subprocess.Popen(cmd, env=full, stdout=fo,
                                          stderr=subprocess.STDOUT))
    return {"procs": procs, "outs": outs, "tmp": tmp, "n": n,
            "target": target, "t0": time.perf_counter()}


def finish_ranks(h: dict, timeout: float = 600.0) -> list[str]:
    """Wait for the ranks of ``start_ranks`` -> each rank's output. When
    one fails, or ``timeout`` seconds after the start, every rank still
    running is killed and ``RuntimeError`` is raised."""
    procs = h["procs"]
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.perf_counter() - h["t0"] > timeout:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = [o.read_text() for o in h["outs"]]
    h["tmp"].cleanup()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(
            f"{h['n']} ranks of {h['target']}: exit codes {codes}\n"
            + "\n".join(f"--- rank {r} ---\n{texts[r][-4000:]}"
                        for r in range(h["n"]) if codes[r]))
    return texts


def _rank_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser()
    for name in ("--rank", "--world"):
        ap.add_argument(name, type=int, required=True)
    for name in ("--init", "--device", "--backend", "--target", "--args"):
        ap.add_argument(name, required=True)
    a = ap.parse_args(argv)
    from apv_tpu_torch.parallel.multihost import init_group
    if torch.device(a.device).type == "cpu":
        torch.set_num_threads(1)
    try:
        init_group(a.rank, a.world, a.init, device=a.device,
                   backend=a.backend or None)
        module, fn = a.target.split(":")
        getattr(importlib.import_module(module), fn)(*json.loads(a.args))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)                  # leave the group's peers to be killed
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

TINY = ("model.z_dim=8", "model.widths=[8,16,16]", "model.blocks_per_stage=1",
        "adversarial.d_widths=[16,16]", "train.batch_size=16")
VARIANTS = (
    ("biadversarial", ("adversarial.variant=biadversarial",
                       "adversarial.pixel_d_widths=[8,16]")),
    ("iwae/dreg objective", ("train.objective=iwae", "train.iwae_k=3",
                             "train.iwae_grad=dreg")),
    ("spectral-norm D", ("adversarial.d_spectral_norm=true",)),
    ("gaussian-base prior", ("model.prior=gaussian",)),
    ("trained flow prior", ("adversarial.enabled=false", "model.prior=flow",
                            "model.prior_flow_layers=2",
                            "model.prior_flow_hidden=8")),
)


def flagship_cfg(*extra: str, results_dir: str = "results"):
    """The reference's tiny flagship, in the port's config."""
    from apv_tpu_torch.utils.config import apply_overrides, get_preset
    return apply_overrides(get_preset("cifar_advprior_resnet"),
                           [*TINY, f"results_dir={results_dir}", *extra])


def replicas_equal(state) -> bool:
    """Whether every rank's state holds the same bits (an all-gather of
    each rank's flattened state)."""
    from apv_tpu_torch.parallel import multihost
    flat = torch.cat([t.detach().reshape(-1).view(torch.uint8)
                      if t.dtype != torch.bool else t.reshape(-1).byte()
                      for t in (x.contiguous() for x in state.tensors())])
    rows = multihost.all_gather_rows(flat[None])
    steps = multihost.all_gather_rows(torch.tensor([[state.step]]))
    return bool(all(torch.equal(rows[0], r) for r in rows)
                and (steps == steps[0]).all())


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _images(cfg, n: int) -> np.ndarray:
    h, w, c = cfg.model.image_shape
    return np.random.default_rng(0).integers(0, 256, size=(n, h, w, c),
                                             dtype=np.uint8)


def _dryrun_rank(device: str, results_dir: str) -> None:
    from apv_tpu_torch.parallel import multihost
    from apv_tpu_torch.parallel.mesh import make_grid_2d
    from apv_tpu_torch.training.loop import train_loop
    from apv_tpu_torch.training.step import make_train_fns

    rank, world = multihost.process_index(), multihost.process_count()
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = flagship_cfg(results_dir=results_dir)
    arrays = {"image": _images(cfg, 4 * cfg.train.batch_size)}

    def finite(m):
        return all(np.isfinite(float(v)) for v in m.values())

    # the loop: plain, two steps a call, the resident set
    for label, extra, steps in (
            ("plain", ("name=dry_plain", "train.steps_per_call=1"), 1),
            ("steps_per_call=2", ("name=dry_k2", "train.steps_per_call=2",
                                  "train.log_every=2"), 2),
            ("device_resident", ("name=dry_res", "train.steps_per_call=1",
                                 "data.device_resident=true"),
             1)):
        c = flagship_cfg(*extra, "train.checkpoint_every=1000",
                         results_dir=results_dir)
        st = train_loop(c, max_steps=steps, arrays=arrays, device=device)
        _check(st.step == steps, f"{label}: step {st.step}")
        _check(replicas_equal(st), f"{label}: the replicas differ")
        say(f"dryrun {label} ok over {world} ranks", flush=True)

    # the step: each variant
    lo, hi = multihost.local_rows(cfg.train.batch_size)
    for label, extra in VARIANTS:
        c = flagship_cfg(*extra, results_dir=results_dir)
        fns = make_train_fns(c, device=device)
        st = fns.init_fn(c.train.seed)
        batch = {"image": torch.from_numpy(arrays["image"][lo:hi]).to(
            fns.device)}
        st, m = fns.train_step(st, batch)
        _check(st.step == 1 and finite(m), f"{label}: {m}")
        _check(replicas_equal(st), f"{label}: the replicas differ")
        say(f"dryrun {label} step ok over {world} ranks", flush=True)

    if world >= 2:
        from apv_tpu_torch.core.flow import init_flow
        from apv_tpu_torch.eval.sharded import make_sharded_iwae_fn
        from apv_tpu_torch.sampling.run import expost_prior_logpdf
        grid = make_grid_2d(world // 2, 2)
        fns = make_train_fns(cfg, device=device)
        model = fns.init_fn(cfg.train.seed).model
        h, w, ch = cfg.model.image_shape
        x = torch.zeros((cfg.train.batch_size // grid.n_data, h, w, ch),
                        device=fns.device)
        flow = init_flow(cfg.model.z_dim, n_layers=2, hidden=8,
                         generator=torch.Generator().manual_seed(1),
                         device=fns.device)
        for label, prior in (("", None),
                             (" flow-prior", expost_prior_logpdf(flow))):
            if grid.member:
                f = make_sharded_iwae_fn(model, cfg.model.likelihood, k=8,
                                         chunk=4, grid=grid,
                                         prior_logpdf=prior)
                with torch.inference_mode():
                    ll = f(x, x, seed=0)
                _check(bool(torch.isfinite(ll).all()), f"k-sharded{label}")
            say(f"dryrun k-sharded{label} IWAE over "
                f"({grid.n_data}, {grid.n_k}) ok", flush=True)


def dryrun_multiproc(n: int, device=None,
                     backend: str | None = None) -> str:
    """The dry run over ``n`` ranks (module docstring) on ``device``
    (``None``: the card); returns rank 0's output and raises when a rank
    fails."""
    from apv_tpu_torch.utils.device import resolve_device
    dev = str(resolve_device(device))
    with tempfile.TemporaryDirectory() as results_dir:
        return spawn(n, "apv_tpu_torch.parallel.dryrun:_dryrun_rank",
                     dev, results_dir, device=dev, backend=backend)[0]


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--rank":
        return _rank_main(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", default=None,
                    help="gloo for ranks that share one card")
    a = ap.parse_args(argv)
    try:
        print(dryrun_multiproc(a.n, a.device, a.backend), end="")
    except (RuntimeError, ValueError) as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
