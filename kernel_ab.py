"""Two builds of the ``reparam`` and ``groupnorm_gelu_bwd`` kernels, timed
side by side on one CUDA card.

    python3 kernel_ab.py --parent DIR [--sass OUT]

DIR is another checkout of this repository (for example ``git archive``
of an earlier commit, unpacked into a directory that ``.gitignore``
lists). Its ``apv_tpu_torch/ops/csrc`` is built with this checkout's
flags into this checkout's ``apv_tpu_torch/ops/_build/parent`` (nothing
is written into DIR) and loaded with the signatures of
DIR's own ``_build.py``, beside this checkout's kernels; each case runs
its C entry point in the order parent, change, change, parent. Per run
(``ITERS`` launches):

* ``call_us``: CUDA events over back-to-back calls from Python (ctypes
  call and launch included; the host sets the pace of small kernels);
* ``queued_us``: CUDA events over the same launches queued behind
  ``torch.cuda._sleep``, so that the card runs them back to back;
* ``device_us``: the profiler's device time a launch, in a window that
  interleaves each launch with a one-element ``neg_`` whose device time
  is the window's ``floor_us`` (the least a launch costs the card).

Cases: ``reparam`` at the IWAE chunk [25, 64, 128], the OOD chunk
[50, 64, 128] and the CIFAR train step's [1, 256, 128]; ``groupnorm_gelu_bwd``
(the kernel that runs there, then the column sum) at [256, 32, 32, 64],
G = 8, bf16 and f32.
The change is also held to the parent (``reparam``: equal bits) and to
the plain version, and ``groupnorm_gelu_bwd`` to itself on a second call
(equal bits), naming the backward kernel that ran where the build
reports it. With ``--sass OUT``: ``nvcc -Xptxas -v`` and ``cuobjdump
-sass`` of both builds of the two sources, written to OUT, with a summary
line per kernel function (registers, spills, instruction count, stores by
width, calls). One JSON line per result; the ``nvidia-smi`` name and
power limit first.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from apv_tpu_torch.ops import _build
from apv_tpu_torch.ops import kernels as K

ITERS = 200
REPARAM_CASES = ((25, (64, 128)), (50, (64, 128)), (1, (256, 128)))
GN_SHAPE, GN_GROUPS = (256, 32, 32, 64), 8
# each case's __global__ functions, to find them in a profile: the one
# that runs once a launch (either name), then any that run beside it
FUNCTIONS = {"reparam": (("reparam_samples",), ()),
             "groupnorm_gelu_bwd": (("groupnorm_gelu_bwd_image",
                                     "groupnorm_gelu_bwd_rows"),
                                    ("groupnorm_gelu_param_sum",))}
SASS_SOURCES = ("reparam.cu", "groupnorm_gelu.cu")

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


def reparam_call(lib: ctypes.CDLL, samples: int, shape: tuple[int, ...],
                 dev: torch.device):
    """(launch, output) for ``apv_reparam`` on seeded [*shape] inputs."""
    rng = np.random.default_rng(0)
    mean = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    logvar = torch.from_numpy(
        rng.uniform(-4.0, 1.0, size=shape).astype(np.float32)).to(dev)
    z = torch.empty((samples, *shape), dtype=torch.float32, device=dev)
    seed, offset = 0x0123456789ABCDEF, 42

    def launch():
        _ok(lib.apv_reparam(mean.data_ptr(), logvar.data_ptr(), z.data_ptr(),
                            samples, mean.numel(), seed, offset, _stream()))

    def plain():
        return K.reparam_plain(mean, logvar, samples, seed, offset)

    return launch, z, plain


def gn_bwd_call(lib: ctypes.CDLL, dtype: torch.dtype, dev: torch.device):
    """(launch, outputs, plain, ran) for ``apv_groupnorm_gelu_bwd`` at
    GN_SHAPE; ``ran`` holds the kernel the last launch reported (-1 from a
    build that does not report it)."""
    rng = np.random.default_rng(1)
    b, h, w, c = GN_SHAPE
    x = torch.from_numpy((rng.normal(size=GN_SHAPE) * 2.0 + 0.3).astype(
        np.float32)).to(dev, dtype)
    dy = torch.from_numpy(rng.normal(size=GN_SHAPE).astype(np.float32)).to(
        dev, dtype)
    gamma = torch.from_numpy((rng.normal(size=c) * 0.5 + 1.0).astype(
        np.float32)).to(dev)
    beta = torch.from_numpy((rng.normal(size=c) * 0.1).astype(
        np.float32)).to(dev)
    _, mean, rstd = K.groupnorm_gelu_plain(x, gamma, beta, GN_GROUPS)
    dx = torch.empty_like(x)
    partials = torch.empty((2, b, c), dtype=torch.float32, device=dev)
    dgamma = torch.empty(c, dtype=torch.float32, device=dev)
    dbeta = torch.empty_like(dgamma)
    fn, ran = lib.apv_groupnorm_gelu_bwd, ctypes.c_int(-1)
    args = [dy.data_ptr(), x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            partials[0].data_ptr(), partials[1].data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(), b, h * w, c, GN_GROUPS,
            int(dtype == torch.bfloat16)]
    if len(fn.argtypes) == len(args) + 2:  # a build that reports its kernel
        args.append(ctypes.byref(ran))

    def launch():
        _ok(fn(*args, _stream()))

    def plain():
        return K.groupnorm_gelu_bwd_plain(dy, x, gamma, beta, mean, rstd,
                                          GN_GROUPS)

    return launch, (dx, dgamma, dbeta), plain, ran


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


def scale_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def measure(name: str, shape: list, libs: dict, make) -> None:
    """parent, change, change, parent; then agreement of the change."""
    calls = {v: make(lib) for v, lib in libs.items()}
    runs = collections.defaultdict(list)
    for version in ("parent", "change", "change", "parent"):
        launch = calls[version][0]
        dev_us, floor = device_us(launch, FUNCTIONS[name])
        runs[version].append({"call_us": call_us(launch),
                              "queued_us": queued_us(launch),
                              "device_us": dev_us, "floor_us": floor})
    for version, rs in runs.items():
        means = {key: (sum(r[key] for r in rs) / len(rs)
                       if all(r[key] is not None for r in rs) else None)
                 for key in rs[0]}
        emit("time", kernel=name, shape=shape, version=version, **means,
             runs=rs)


def agree_reparam(libs: dict, dev: torch.device) -> None:
    for samples, shape in REPARAM_CASES + ((3, (7, 5)),):
        outs = {}
        for version, lib in libs.items():
            launch, z, plain = reparam_call(lib, samples, shape, dev)
            launch()
            outs[version] = z.clone()
        want = plain()
        rel = float(((outs["change"] - want).abs() / (1.0 + want.abs()))
                    .max())
        emit("agree", kernel="reparam", shape=[samples, *shape],
             equal_bits_to_parent=bool(torch.equal(outs["change"],
                                                   outs["parent"])),
             rel_err_vs_plain=rel, tol=1e-5)


def agree_gn(libs: dict, dev: torch.device) -> None:
    for dtype in (torch.bfloat16, torch.float32):
        got, ran = {}, {}
        for version, lib in libs.items():
            launch, outs, plain, ran[version] = gn_bwd_call(lib, dtype, dev)
            launch()
            got[version] = tuple(t.clone() for t in outs)
            if version == "change":
                launch()
                same = all(torch.equal(a, b) for a, b in zip(got[version],
                                                              outs))
        want = plain()
        emit("agree", kernel="groupnorm_gelu_bwd", shape=list(GN_SHAPE),
             dtype=str(dtype).removeprefix("torch."),
             scale_rel_vs_plain=max(scale_rel(a, w) for a, w in
                                    zip(got["change"], want)),
             parent_scale_rel_vs_plain=max(scale_rel(a, w) for a, w in
                                           zip(got["parent"], want)),
             tol=1e-2 if dtype == torch.bfloat16 else 1e-4,
             same_bits_on_second_call=same,
             ran={v: (K.GN_BWD_KERNELS[r.value] if r.value >= 0 else None)
                     for v, r in ran.items()})


def summarize_listing(ptxas: str, sass: str) -> list[dict]:
    """One row per kernel function of a ``cuobjdump -sass`` listing, with
    its registers and spills from ``nvcc -Xptxas -v`` output, its
    instruction count, its global stores and loads by opcode, and its
    CALL and MUFU counts."""
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
                     "instructions": len(ops),
                     "stores": {k: v for k, v in count.items()
                                if k.startswith("STG")},
                     "loads": {k: v for k, v in count.items()
                               if k.startswith("LDG")},
                     "calls": sum(v for k, v in count.items()
                                  if k.startswith("CALL")),
                     "mufu": sum(v for k, v in count.items()
                                 if k.startswith("MUFU"))})
    return rows


def sass_report(csrc: Path, version: str, out: Path) -> None:
    """``-Xptxas -v`` and ``cuobjdump -sass`` of SASS_SOURCES, saved to
    ``out``; one summary line per kernel function."""
    nvcc = _build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).parent
                                                 / "cuobjdump")
    out.mkdir(parents=True, exist_ok=True)
    for src in SASS_SOURCES:
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
    ap.add_argument("--parent", type=Path, required=True,
                    help="another checkout of this repository")
    ap.add_argument("--sass", type=Path, default=None,
                    help="write ptxas and SASS listings of both builds here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; this comparison runs on the card",
              file=sys.stderr)
        return 1
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
        agree_reparam(libs, dev)
        agree_gn(libs, dev)
        for samples, shape in REPARAM_CASES:
            measure("reparam", [samples, *shape], libs,
                    lambda lib: reparam_call(lib, samples, shape, dev))
        for dtype in (torch.bfloat16, torch.float32):
            measure("groupnorm_gelu_bwd",
                    [*GN_SHAPE, str(dtype).removeprefix("torch.")], libs,
                    lambda lib: gn_bwd_call(lib, dtype, dev))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
