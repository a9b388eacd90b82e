"""Two builds of the port's kernels, timed side by side on one CUDA card.

    python3 kernel_ab.py --parent DIR [--sass OUT] [--host]

DIR is another checkout of this repository (for example ``git archive``
of an earlier commit, unpacked into a directory that ``.gitignore``
lists). Its ``apv_tpu_torch/ops/csrc`` is built with this checkout's
flags into this checkout's ``apv_tpu_torch/ops/_build/parent`` (nothing
is written into DIR) and loaded with the signatures of
DIR's own ``_build.py``, beside this checkout's kernels.

``CASES`` is the table: each row names a kernel, its shape and dtype,
the C source it lives in, a function that makes the launch
(``make(lib, dev)`` -> a ``Call``: the launch, its outputs, the plain version's outputs and the
route the build reported) and an agreement check (``check(got, want)``
-> fields with ``ok``). To add a kernel, add a row. For every row, each
build launches once, the change a second time (equal bits required), and
the check holds the change to the plain version (and, where it asks, to
the parent's bits). Each timed row then runs in the order parent,
change, change, parent; per run (``ITERS`` launches):

* ``call_us``: CUDA events over back-to-back calls from Python (ctypes
  call and launch included; the host sets the pace of small kernels);
* ``queued_us``: CUDA events over the same launches queued behind
  ``torch.cuda._sleep``, so that the card runs them back to back;
* ``device_us``: the profiler's device time a launch, in a window that
  interleaves each launch with a one-element ``neg_`` whose device time
  is the window's ``floor_us`` (the least a launch costs the card).

With ``--host``: the two likelihood ops as the paths call them, through
each checkout's own wrappers (``apv_tpu_torch.ops``, its autograd
rules, ``ops/kernels.py`` and the launch), host µs a call over
back-to-back calls (``"kind": "host"``), each checkout in a process of
its own (``python3 -P`` with that checkout on ``PYTHONPATH``), in the
order parent, change, change, parent. The parent's IWAE-chunk call
expands x to the parameters' rows first, as its paths did.

With ``--sass OUT``: ``nvcc -Xptxas -v`` and ``cuobjdump -sass`` of both
builds of the rows' sources, written to OUT, with a summary line per
kernel function (registers, spills, instruction count, stores by width,
calls, 64-bit division routines). One JSON line per result; the
``nvidia-smi`` name and power limit first. Exits 1 if a check failed.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import functools
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from apv_tpu_torch.ops import _build
from apv_tpu_torch.ops import kernels as K

ITERS = 200
GN_SHAPE, GN_GROUPS = (256, 32, 32, 64), 8
BERN_SHAPE = (256, 784)          # the MNIST train step's [batch, pixels]


def emit(kind: str, **fields) -> None:
    print(json.dumps({"kind": kind, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ok(status: int) -> None:
    if status != 0:
        raise RuntimeError(f"kernel launch failed with cudaError_t {status}")


class Call(NamedTuple):
    """One build's launch of a case on fixed inputs."""
    launch: Callable[[], None]
    outputs: tuple[torch.Tensor, ...]       # written by launch()
    plain: Callable[[], tuple[torch.Tensor, ...]]   # the plain version's
    ran: ctypes.c_int | None = None         # the route the build reported


def _seeded(rng, shape, scale=1.0, shift=0.0, dtype=torch.float32,
            dev="cuda") -> torch.Tensor:
    return torch.from_numpy((rng.normal(size=shape) * scale + shift).astype(
        np.float32)).to(dev, dtype)


def reparam_call(samples: int, shape: tuple[int, ...], lib: ctypes.CDLL,
                 dev: torch.device) -> Call:
    """``apv_reparam`` on seeded [*shape] inputs."""
    rng = np.random.default_rng(0)
    mean = _seeded(rng, shape, dev=dev)
    logvar = torch.from_numpy(
        rng.uniform(-4.0, 1.0, size=shape).astype(np.float32)).to(dev)
    z = torch.empty((samples, *shape), dtype=torch.float32, device=dev)
    seed, offset = 0x0123456789ABCDEF, 42

    def launch():
        _ok(lib.apv_reparam(mean.data_ptr(), logvar.data_ptr(), z.data_ptr(),
                            samples, mean.numel(), seed, offset, _stream()))

    return Call(launch, (z,), lambda: (K.reparam_plain(mean, logvar, samples,
                                                       seed, offset),))


def _gn_inputs(dtype: torch.dtype, dev: torch.device):
    rng = np.random.default_rng(1)
    c = GN_SHAPE[-1]
    x = _seeded(rng, GN_SHAPE, 2.0, 0.3, dtype, dev)
    dy = _seeded(rng, GN_SHAPE, dtype=dtype, dev=dev)
    gamma = _seeded(rng, c, 0.5, 1.0, dev=dev)
    beta = _seeded(rng, c, 0.1, dev=dev)
    return x, dy, gamma, beta


def _with_route(fn, args: list) -> ctypes.c_int:
    """Append the route out-parameter where the build's entry point takes
    one (its signature has one more pointer before the stream); the
    returned int stays -1 otherwise."""
    ran = ctypes.c_int(-1)
    if len(fn.argtypes) == len(args) + 2:
        args.append(ctypes.byref(ran))
    return ran


def gn_fwd_call(dtype: torch.dtype, lib: ctypes.CDLL,
                dev: torch.device) -> Call:
    """``apv_groupnorm_gelu`` at GN_SHAPE."""
    x, _, gamma, beta = _gn_inputs(dtype, dev)
    b, h, w, c = GN_SHAPE
    y = torch.empty_like(x)
    mean = torch.empty((b, GN_GROUPS), dtype=torch.float32, device=dev)
    rstd = torch.empty_like(mean)
    fn = lib.apv_groupnorm_gelu
    args = [x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), b, h * w, c, GN_GROUPS, 1e-6,
            int(dtype == torch.bfloat16)]
    ran = _with_route(fn, args)
    return Call(lambda: _ok(fn(*args, _stream())), (y, mean, rstd),
                lambda: K.groupnorm_gelu_plain(x, gamma, beta, GN_GROUPS),
                ran)


def gn_bwd_call(dtype: torch.dtype, lib: ctypes.CDLL,
                dev: torch.device) -> Call:
    """``apv_groupnorm_gelu_bwd`` at GN_SHAPE (the kernel that runs there,
    then the column sum), on the plain forward's statistics."""
    x, dy, gamma, beta = _gn_inputs(dtype, dev)
    b, h, w, c = GN_SHAPE
    _, mean, rstd = K.groupnorm_gelu_plain(x, gamma, beta, GN_GROUPS)
    dx = torch.empty_like(x)
    partials = torch.empty((2, b, c), dtype=torch.float32, device=dev)
    dgamma = torch.empty(c, dtype=torch.float32, device=dev)
    dbeta = torch.empty_like(dgamma)
    fn = lib.apv_groupnorm_gelu_bwd
    args = [dy.data_ptr(), x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            partials[0].data_ptr(), partials[1].data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(), b, h * w, c, GN_GROUPS,
            int(dtype == torch.bfloat16)]
    ran = _with_route(fn, args)
    return Call(lambda: _ok(fn(*args, _stream())), (dx, dgamma, dbeta),
                lambda: K.groupnorm_gelu_bwd_plain(dy, x, gamma, beta, mean,
                                                   rstd, GN_GROUPS),
                ran)


def bernoulli_bwd_call(lib: ctypes.CDLL, dev: torch.device) -> Call:
    """``apv_bernoulli_bwd`` at BERN_SHAPE without dx, as the train step
    calls it."""
    rng = np.random.default_rng(2)
    rows, event = BERN_SHAPE
    x = torch.from_numpy((rng.random(BERN_SHAPE) < 0.2).astype(
        np.float32)).to(dev)
    logits = _seeded(rng, BERN_SHAPE, 3.0, dev=dev)
    g = _seeded(rng, rows, dev=dev)
    dl = torch.empty_like(logits)

    def launch():
        _ok(lib.apv_bernoulli_bwd(g.data_ptr(), x.data_ptr(),
                                  logits.data_ptr(), None, dl.data_ptr(),
                                  rows, event, _stream()))

    return Call(launch, (dl,),
                lambda: K.bernoulli_bwd_plain(g, x, logits)[1:])


LIK_EVENT = {"disc_logistic": 3072, "bernoulli": 784}   # CIFAR, MNIST pixels


def _x_args(fn, x: torch.Tensor, like: torch.Tensor, n_new: int):
    """x and the trailing x_rows argument for a likelihood entry point:
    x [B, E] and B where the build's entry point takes ``x_rows`` (``n_new``
    parameters), else x repeated to ``like``'s rows, made once here (the
    parent's signature: the copy the path made before the kernel)."""
    if len(fn.argtypes) == n_new:
        return x, [x.shape[0]]
    return K.expand_rows(x, like).contiguous(), []


def disc_logistic_call(rows: int, x_rows: int, lib: ctypes.CDLL,
                       dev: torch.device) -> Call:
    """``apv_disc_logistic`` on mean, log_scale [rows, 3072] beside x
    [x_rows, 3072]: every level and both edges, the -7 floor, and two rows
    whose bins reach the t <= 1e-3 series (as chip_smoke.py sets them)."""
    rng = np.random.default_rng(3)
    event = LIK_EVENT["disc_logistic"]
    x = rng.integers(0, 256, size=(x_rows, event)) / 255.0
    x[0, :256] = np.arange(256) / 255.0
    mean = rng.uniform(-0.2, 1.2, size=(rows, event))
    ls = rng.uniform(-7.0, 0.0, size=(rows, event))
    ls[1] = -7.0
    ls[2] = np.linspace(3.4, 5.5, event)     # t 1.3e-4 down to 1.6e-5
    ls[3] = np.linspace(1.2, 1.5, event)     # t across 1e-3
    x, mean, ls = (torch.from_numpy(v.astype(np.float32)).to(dev)
                   for v in (x, mean, ls))
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    fn = lib.apv_disc_logistic
    xk, extra = _x_args(fn, x, mean, 9)
    args = [xk.data_ptr(), mean.data_ptr(), ls.data_ptr(), out.data_ptr(),
            rows, event, *extra, 1.0 / 255.0]
    return Call(lambda: _ok(fn(*args, _stream())), (out,),
                lambda: (K.disc_logistic_plain(x, mean, ls),))


def bernoulli_call(rows: int, x_rows: int, lib: ctypes.CDLL,
                   dev: torch.device) -> Call:
    """``apv_bernoulli`` on logits [rows, 784] beside x [x_rows, 784]."""
    rng = np.random.default_rng(4)
    event = LIK_EVENT["bernoulli"]
    x = torch.from_numpy((rng.random((x_rows, event)) < 0.2).astype(
        np.float32)).to(dev)
    logits = _seeded(rng, (rows, event), 3.0, dev=dev)
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    fn = lib.apv_bernoulli
    xk, extra = _x_args(fn, x, logits, 7)
    args = [xk.data_ptr(), logits.data_ptr(), out.data_ptr(), rows, event,
            *extra]
    return Call(lambda: _ok(fn(*args, _stream())), (out,),
                lambda: (K.bernoulli_plain(x, logits),))


# ---------------------------------------------------------------------------
# agreement checks: check(got, want) -> fields, with "ok"; got maps each
# version to its outputs, want is the plain version's
# ---------------------------------------------------------------------------

def scale_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def elem_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (1 + |want|), elementwise."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (1.0 + want.abs())).max())


def parents_bits(tol: float):
    """The parent's bits, and elementwise within ``tol`` of plain."""
    def check(got: dict, want: tuple) -> dict:
        same = all(torch.equal(a, b)
                   for a, b in zip(got["change"], got["parent"]))
        rel = max(elem_rel(a, w) for a, w in zip(got["change"], want))
        return {"equal_bits_to_parent": same, "rel_err_vs_plain": rel,
                "tol": tol, "ok": same and rel <= tol}
    return check


def gn_forward_bars(dtype: torch.dtype):
    """y within 1e-5 (f32) or 2^-7 (bf16) of max(max |y|, 1), mean and
    rstd within 1e-5 scale-relative, as chip_smoke.py holds them."""
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7

    def errs(out, want):
        y, yw = out[0].float(), want[0].float()
        fwd = float((y - yw).abs().max()) / max(float(yw.abs().max()), 1.0)
        return fwd, max(scale_rel(a, w) for a, w in zip(out[1:], want[1:]))

    def check(got: dict, want: tuple) -> dict:
        fwd, stats = errs(got["change"], want)
        p_fwd, p_stats = errs(got["parent"], want)
        return {"fwd_vs_plain": fwd, "stats_vs_plain": stats,
                "parent_fwd_vs_plain": p_fwd,
                "parent_stats_vs_plain": p_stats, "tol_fwd": tol,
                "tol_stats": 1e-5, "ok": fwd <= tol and stats <= 1e-5}
    return check


def gn_backward_bars(dtype: torch.dtype):
    """dx, dgamma, dbeta within 1e-4 (f32) or 1e-2 (bf16) scale-relative."""
    tol = 1e-4 if dtype == torch.float32 else 1e-2

    def check(got: dict, want: tuple) -> dict:
        rel = {v: max(scale_rel(a, w) for a, w in zip(out, want))
               for v, out in got.items()}
        return {"scale_rel_vs_plain": rel["change"],
                "parent_scale_rel_vs_plain": rel["parent"], "tol": tol,
                "ok": rel["change"] <= tol}
    return check


def sum_bars(abs_tol: float, rel_tol: float):
    """Per-row sums within abs_tol + rel_tol·max |plain| of the plain
    version, as chip_smoke.py holds them (another summation order, and
    for disc_logistic approximate intrinsics); the parent's error beside."""
    def check(got: dict, want: tuple) -> dict:
        tol = abs_tol + rel_tol * float(want[0].abs().max())
        err = {v: float((out[0] - want[0]).abs().max())
               for v, out in got.items()}
        return {"max_abs_err_vs_plain": err["change"],
                "parent_max_abs_err_vs_plain": err["parent"], "tol": tol,
                "ok": err["change"] <= tol}
    return check


class Case(NamedTuple):
    kernel: str
    shape: tuple                       # the likelihoods': (rows, x rows, E)
    dtype: torch.dtype
    source: str                        # under apv_tpu_torch/ops/csrc
    make: Callable[[ctypes.CDLL, torch.device], Call]
    check: Callable[[dict, tuple], dict]
    # __global__ functions, to find them in a profile: the one that runs
    # once a launch (any of these names), then any that run beside it
    functions: tuple[tuple[str, ...], tuple[str, ...]]
    routes: tuple[str, ...] = ()       # names of the reported routes
    timed: bool = True


_GN_FWD_FNS = (("groupnorm_gelu_image", "groupnorm_gelu_rows"), ())
_GN_BWD_FNS = (("groupnorm_gelu_bwd_image", "groupnorm_gelu_bwd_rows"),
               ("groupnorm_gelu_param_sum",))
CASES = (
    *(Case("reparam", (s, *shape), torch.float32, "reparam.cu",
           functools.partial(reparam_call, s, shape), parents_bits(1e-5),
           (("reparam_samples",), ()), timed=timed)
      for s, shape, timed in ((25, (64, 128), True), (50, (64, 128), True),
                              (1, (256, 128), True), (3, (7, 5), False))),
    *(Case("groupnorm_gelu", GN_SHAPE, dtype, "groupnorm_gelu.cu",
           functools.partial(gn_fwd_call, dtype), gn_forward_bars(dtype),
           _GN_FWD_FNS, K.GN_KERNELS)
      for dtype in (torch.bfloat16, torch.float32)),
    *(Case("groupnorm_gelu_bwd", GN_SHAPE, dtype, "groupnorm_gelu.cu",
           functools.partial(gn_bwd_call, dtype), gn_backward_bars(dtype),
           _GN_BWD_FNS, K.GN_KERNELS)
      for dtype in (torch.bfloat16, torch.float32)),
    Case("bernoulli_bwd", BERN_SHAPE, torch.float32, "bernoulli.cu",
         bernoulli_bwd_call, parents_bits(1e-6),
         (("bernoulli_bwd_rows", "bernoulli_bwd_elems"), ())),
    # (rows, x rows): the OOD and IWAE chunks (x broadcast over 50 and 25
    # samples), the CIFAR train step
    *(Case("disc_logistic", (rows, x_rows, 3072), torch.float32,
           "disc_logistic.cu",
           functools.partial(disc_logistic_call, rows, x_rows),
           sum_bars(1e-2, 1e-5), (("disc_logistic_rows",), ()))
      for rows, x_rows in ((3200, 64), (1600, 64), (256, 256))),
    # the MNIST train step, the MNIST IWAE chunk (x over 50 samples)
    *(Case("bernoulli", (rows, x_rows, 784), torch.float32, "bernoulli.cu",
           functools.partial(bernoulli_call, rows, x_rows),
           sum_bars(1e-4, 1e-6), (("bernoulli_rows",), ()))
      for rows, x_rows in ((256, 256), (3200, 64))),
)


def _dtype(case: Case) -> str:
    return str(case.dtype).removeprefix("torch.")


def call_us(launch, iters: int = ITERS) -> float:
    """Back-to-back calls from Python, CUDA events, µs a call."""
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def queued_us(launch, iters: int = ITERS) -> float:
    """The same launches queued behind a ~20 ms spin of the card, so that
    the host has enqueued them all before the first one runs."""
    launch()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def device_us(launch, functions: tuple[tuple[str, ...], tuple[str, ...]],
              iters: int = ITERS) -> tuple[float | None, float | None]:
    """(device µs a launch of ``functions`` summed, the one-element
    ``neg_``'s device µs a launch) from one profiler window."""
    from torch.profiler import ProfilerActivity, profile
    one = torch.zeros(1, device="cuda")
    launch()
    one.neg_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            launch()
            one.neg_()
        torch.cuda.synchronize()

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages()
              if "CUDA" in str(e.device_type) and dev(e) > 0]
    def named(fns):
        return [e for e in events for fn in fns
                if f"::{fn}(" in e.key or f"::{fn}<" in e.key]

    main, beside = named(functions[0]), named(functions[1])
    ours = main + beside
    floor = [e for e in events if "neg" in e.key]
    calls = sum(e.count for e in main)
    floor_calls = sum(e.count for e in floor)
    return (sum(map(dev, ours)) / calls if calls else None,
            sum(map(dev, floor)) / floor_calls if floor_calls else None)


def measure(case: Case, libs: dict, dev: torch.device) -> None:
    """parent, change, change, parent."""
    calls = {v: case.make(lib, dev) for v, lib in libs.items()}
    runs = collections.defaultdict(list)
    for version in ("parent", "change", "change", "parent"):
        launch = calls[version].launch
        dev_us, floor = device_us(launch, case.functions)
        runs[version].append({"call_us": call_us(launch),
                              "queued_us": queued_us(launch),
                              "device_us": dev_us, "floor_us": floor})
    for version, rs in runs.items():
        means = {key: (sum(r[key] for r in rs) / len(rs)
                       if all(r[key] is not None for r in rs) else None)
                 for key in rs[0]}
        emit("time", kernel=case.kernel, shape=list(case.shape),
             dtype=_dtype(case), version=version, **means, runs=rs)


def measure_copy(case: Case, dev: torch.device) -> None:
    """The copy of x that the parent's paths made before a broadcast
    likelihood launch: x [B, E] expanded to the parameters' [R, E] and
    reshaped (one copy kernel a chunk), µs a call, call and queued."""
    rows, x_rows, event = case.shape
    x = torch.rand((x_rows, event), device=dev)

    def copy():
        x.unsqueeze(0).expand(rows // x_rows, x_rows, event).reshape(
            rows, event)

    emit("copy", kernel=case.kernel, shape=list(case.shape),
         call_us=call_us(copy), queued_us=queued_us(copy),
         bytes=4 * (x_rows + rows) * event)


def agree(case: Case, libs: dict, dev: torch.device) -> bool:
    """Each build once, the change twice; the case's check against the
    plain version. Emits one line; returns its ``ok``."""
    calls, got = {}, {}
    for version, lib in libs.items():
        calls[version] = call = case.make(lib, dev)
        call.launch()
        got[version] = tuple(t.clone() for t in call.outputs)
    change = calls["change"]
    change.launch()
    same = all(torch.equal(a, b) for a, b in zip(got["change"],
                                                 change.outputs))
    fields = case.check(got, tuple(change.plain()))
    ran = {v: case.routes[c.ran.value]
           for v, c in calls.items() if c.ran is not None and c.ran.value >= 0}
    ok = fields.pop("ok") and same
    emit("agree", kernel=case.kernel, shape=list(case.shape),
         dtype=_dtype(case), same_bits_on_second_call=same, ran=ran,
         **fields, ok=ok)
    return ok


def summarize_listing(ptxas: str, sass: str) -> list[dict]:
    """One row per kernel function of a ``cuobjdump -sass`` listing, with
    its registers and spills from ``nvcc -Xptxas -v`` output, its
    instruction count, its global stores and loads by opcode, its CALL
    and MUFU counts, and its calls of the 64-bit division and remainder
    routines (``div64``)."""
    regs = {}
    for fn, body in re.findall(
            r"Compiling entry function '(\S+)' for 'sm_\w+'\n(.*?)"
            r"(?=Compiling entry function|\Z)", ptxas, re.S):
        used = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", body)
        regs[fn] = {"registers": int(used.group(1)) if used else None,
                    "spill_stores": int(spill.group(1)) if spill else None,
                    "spill_loads": int(spill.group(2)) if spill else None}
    rows = []
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)",
                               sass, re.S):
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                         body)
        count = collections.Counter(ops)
        rows.append({"function": fn, **regs.get(fn, {}),
                     "instructions": len(ops), "loops": sass_loops(body),
                     "stores": {k: v for k, v in count.items()
                                if k.startswith("STG")},
                     "loads": {k: v for k, v in count.items()
                               if k.startswith("LDG")},
                     "calls": sum(v for k, v in count.items()
                                  if k.startswith("CALL")),
                     "mufu": sum(v for k, v in count.items()
                                 if k.startswith("MUFU")),
                     "div64": len(re.findall(
                         r"CALL\S*\s+`?\(?\$?\S*cuda_sm\d+_(?:div|rem)_[su]64",
                         body))})
    return rows


def sass_loops(body: str) -> list[int]:
    """The instruction count of each loop of one function's SASS listing:
    a branch back to an earlier address (``BRA 0x1c0`` or a ``.L_x_n``
    label) closes a loop of (branch - target) / 16 + 1 instructions (SASS
    instructions are 16 bytes on sm_90); the branch to itself that pads a
    function's end is none. Sorted, shortest first."""
    labels, pending, loops = {}, [], []
    branches = []
    for line in body.splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        inst = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][\w.]*)(.*)", line)
        if not inst:
            continue
        addr = int(inst.group(1), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        if inst.group(2).startswith("BRA"):
            target = re.search(r"`?\(?(\.L_x_\d+)\)?|0x([0-9a-f]+)",
                               inst.group(3))
            if target:
                branches.append((addr, target.group(1),
                                 int(target.group(2), 16)
                                 if target.group(2) else None))
    for addr, label, hexaddr in branches:
        dest = labels.get(label) if label else hexaddr
        if dest is not None and dest < addr:
            loops.append((addr - dest) // 16 + 1)
    return sorted(loops)


def sass_report(csrc: Path, version: str, out: Path) -> None:
    """``-Xptxas -v`` and ``cuobjdump -sass`` of the sources of CASES,
    saved to ``out``; one summary line per kernel function."""
    nvcc = _build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).parent
                                                 / "cuobjdump")
    out.mkdir(parents=True, exist_ok=True)
    for src in sorted({case.source for case in CASES}):
        obj = out / f"{version}_{Path(src).stem}.o"
        res = subprocess.run(
            [nvcc, *_build.ARCH_FLAGS, *_build.COMPILE_FLAGS, "-Xptxas", "-v",
             "-I", str(csrc), "-c", str(csrc / src), "-o", str(obj)],
            capture_output=True, text=True, check=True)
        ptxas = res.stdout + res.stderr
        (out / f"{version}_{Path(src).stem}_ptxas.txt").write_text(ptxas)
        sass = subprocess.run([cuobjdump, "-sass", str(obj)],
                              capture_output=True, text=True,
                              check=True).stdout
        (out / f"{version}_{Path(src).stem}.sass").write_text(sass)
        for row in summarize_listing(ptxas, sass):
            emit("sass", version=version, source=src, **row)


def host_us(fn, iters: int = 1000) -> float:
    """Wall µs a call over back-to-back calls, the card drained at the
    end: the host's pace where each call's kernels take less."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / iters


def host_child(version: str, lib_dir: Path) -> None:
    """The ``--host`` timings of the checkout this process imported
    ``apv_tpu_torch`` from, its kernels built into ``lib_dir``: the train
    steps' calls (x at the parameters' rows, forward and forward with
    backward) and the IWAE chunk's (mean, log_scale [25·64, ...] beside
    the batch's x [64, ...])."""
    import inspect
    from apv_tpu_torch import ops
    _build.library = functools.cache(
        lambda: _build.load(_build.build(_build.CSRC, lib_dir)))
    rng = np.random.default_rng(5)

    def dev(a, grad=False):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda() \
            .requires_grad_(grad)

    mnist, cifar, chunk = (256, 28, 28, 1), (256, 32, 32, 3), 25
    xb = dev(rng.random(mnist) < 0.2)
    lb = [dev(3.0 * rng.normal(size=mnist), g) for g in (False, True)]
    xd = dev(rng.integers(0, 256, size=cifar) / 255.0)
    md, sd = ([dev(rng.uniform(lo, hi, size=cifar), g) for g in (False, True)]
              for lo, hi in ((-0.2, 1.2), (-7.0, 0.0)))
    xc = xd[:64]
    mc, sc = (dev(rng.uniform(lo, hi, size=(chunk * 64, *cifar[1:])))
              for lo, hi in ((-0.2, 1.2), (-7.0, 0.0)))
    broadcast = "samples" in inspect.signature(
        ops.disc_logistic_recon_ll).parameters

    def iwae_chunk():
        if broadcast:
            return ops.disc_logistic_recon_ll(xc, mc, sc, samples=chunk)
        return ops.disc_logistic_recon_ll(
            xc.unsqueeze(0).expand(chunk, *xc.shape).reshape(mc.shape),
            mc, sc)

    cases = {
        "bernoulli [256,784] forward":
            lambda: ops.bernoulli_recon_ll(xb, lb[0]),
        "bernoulli [256,784] forward+backward":
            lambda: ops.bernoulli_recon_ll(xb, lb[1]).sum().backward(),
        "disc_logistic [256,3072] forward":
            lambda: ops.disc_logistic_recon_ll(xd, md[0], sd[0]),
        "disc_logistic [256,3072] forward+backward":
            lambda: ops.disc_logistic_recon_ll(xd, md[1],
                                               sd[1]).sum().backward(),
        "disc_logistic [1600,3072] x [64,3072] forward": iwae_chunk,
    }
    for case, fn in cases.items():
        emit("host", version=version, case=case, us=host_us(fn))


def host_compare(parent: Path) -> None:
    """``host_child`` of the parent and of this checkout, each in a
    process of its own, parent, change, change, parent."""
    roots = {"parent": (parent, _build.BUILD_DIR / "parent"),
             "change": (Path(__file__).resolve().parent, _build.BUILD_DIR)}
    for version in ("parent", "change", "change", "parent"):
        root, lib_dir = roots[version]
        subprocess.run([sys.executable, "-P", str(Path(__file__).resolve()),
                        "--host-child", version, str(lib_dir)],
                       cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
                       check=True)


def parent_signatures(parent: Path) -> dict:
    """The C signatures of another checkout's kernels, from that
    checkout's own ``apv_tpu_torch/ops/_build.py`` (``SIGNATURES``)."""
    spec = importlib.util.spec_from_file_location(
        "_parent_build", parent / "apv_tpu_torch" / "ops" / "_build.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.SIGNATURES


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout of this repository")
    ap.add_argument("--sass", type=Path, default=None,
                    help="write ptxas and SASS listings of both builds here")
    ap.add_argument("--host", action="store_true",
                    help="also time the likelihood ops' wrappers of both "
                         "checkouts, host µs a call")
    ap.add_argument("--host-child", nargs=2, metavar=("VERSION", "LIB_DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; this comparison runs on the card",
              file=sys.stderr)
        return 1
    if args.host_child:
        host_child(args.host_child[0], Path(args.host_child[1]))
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    parent = args.parent.resolve()
    parent_csrc = parent / "apv_tpu_torch" / "ops" / "csrc"
    emit("device", nvidia_smi=nvidia_smi(), torch=torch.__version__,
         cuda=torch.version.cuda)
    libs = {"parent": _build.load(_build.build(parent_csrc,
                                               _build.BUILD_DIR / "parent"),
                                  parent_signatures(parent)),
            "change": _build.library()}
    dev = torch.device("cuda")
    if args.sass is not None:
        for version, csrc in (("parent", parent_csrc),
                              ("change", _build.CSRC)):
            sass_report(csrc, version, args.sass)
    with torch.inference_mode():
        ok = [agree(case, libs, dev) for case in CASES]
        for case in CASES:
            if case.timed:
                measure(case, libs, dev)
            if case.kernel in LIK_EVENT and case.shape[1] < case.shape[0]:
                measure_copy(case, dev)
    if args.host:
        host_compare(parent)
    return 0 if all(ok) else 1

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
