"""Build and load the port's CUDA kernels.

The sources in ``ops/csrc/`` have a plain C interface. They are compiled
with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per source, all started
together, then one link; each source holds an op's forward kernel and, where
the op is differentiated, its backward kernel) into ``ops/_build/libapv_kernels-<hash>.so`` and
loaded with ``ctypes``. The file name carries a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is reused.

Nothing here runs at import: the build happens the first time a CUDA tensor
reaches a kernel, or when ``library()`` is called. ``build(csrc, out_dir)``
and ``load`` also serve another checkout's sources (``kernel_ab.py`` at the
repo's root times two versions of a kernel side by side).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# No --use_fast_math: the kernels pick their approximate intrinsics one by
# one (each with its range and error stated); expf, expm1f and the t -> 0
# branch of log(expm1(t)) stay libm's.
COMPILE_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64
# C symbol -> argtypes; every entry point returns its launch's cudaError_t.
SIGNATURES = {
    # the likelihoods' x_rows (after event): x's distinct rows, dividing rows
    "apv_bernoulli": (_P, _P, _P, _I64, _I64, _I64, _P),
    "apv_bernoulli_bwd": (_P, _P, _P, _P, _P, _I64, _I64, _P),
    "apv_disc_logistic": (_P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float,
                          _P),
    "apv_conv3x3_simt": (_P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                         ctypes.c_int, _P),
    "apv_conv3x3_wgmma": (_P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                          ctypes.c_int, _P),
    "apv_disc_logistic_bwd": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                              ctypes.c_float, _P),
    # each groupnorm int* out: the kernel that ran (0 image, 1 rows)
    "apv_groupnorm_gelu": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                           ctypes.c_float, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int), _P),
    "apv_groupnorm_gelu_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I64, _I64, _I64, _I64, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int), _P),
    "apv_kl": (_P, _P, _P, _I64, _I64, _P),
    "apv_kl_bwd": (_P, _P, _P, _P, _P, _I64, _I64, _P),
    "apv_reparam": (_P, _P, _P, _I64, _I64, _U64, _U64, _P),
    "apv_reparam_bwd": (_P, _P, _P, _P, _P, _I64, _I64, _P),
}

build_seconds: float | None = None   # wall time of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from ops/csrc/ with the CUDA toolkit's nvcc")


def _sources(csrc: Path) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def _digest(csrc: Path = CSRC) -> str:
    h = hashlib.sha256()
    for p in sorted(csrc.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with nvcc's output on a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failures = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))


def build(csrc: Path = CSRC, out_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernels of ``csrc`` into ``out_dir`` if this source hash
    has no library there yet."""
    global build_seconds
    lib = out_dir / f"libapv_kernels-{_digest(csrc)}.so"
    if lib.exists():
        return lib
    t0 = time.perf_counter()
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = _sources(csrc)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        _run_all([[nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-I", str(csrc),
                   "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(sources, objs)])
        staged = Path(tmp) / lib.name
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged),
                   *map(str, objs)]])
        os.replace(staged, lib)      # atomic: a concurrent build is harmless
    build_seconds = time.perf_counter() - t0
    return lib


def load(path: Path, signatures: dict = SIGNATURES) -> ctypes.CDLL:
    """A built kernel library with every entry point's signature set (from
    ``signatures``: another checkout's library takes that checkout's)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    return load(build())
