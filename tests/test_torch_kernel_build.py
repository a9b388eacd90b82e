"""The kernel build and the side-by-side timing tool, on the CPU.

``ops/_build.py`` compiles any checkout's ``ops/csrc`` (``build(csrc,
out_dir)``) into a library named by a hash of its sources, and
``kernel_ab.py`` (at the repo's root) builds two checkouts' kernels and
times them on the card. Neither can compile or run here (no nvcc, no
card); these tests hold what they do before that: the source hash, the
refusal without nvcc or a card, the parent's own signatures, the
parsing of ptxas and SASS listings, and the names and arities that
``chip_smoke.py``, ``kernel_ab.py`` and ``_build.SIGNATURES`` give the
CUDA sources.
"""

import ctypes
import importlib.util
import re
import shutil
from pathlib import Path

import pytest
import torch

from apv_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("kernel_ab",
                                               ROOT / "kernel_ab.py")
kernel_ab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kernel_ab)
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _sources() -> str:
    return "\n".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))


def _globals() -> set[str]:
    """The names of the ``__global__`` functions of ``ops/csrc``."""
    return set(re.findall(
        r"__global__\s+void\s+"
        r"(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(",
        _sources()))


def _entry_points() -> dict[str, int]:
    """Each ``extern "C"`` entry point of ``ops/csrc`` -> its number of
    parameters."""
    return {name: len(params.split(","))
            for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', _sources())}

PTXAS = """\
ptxas info    : 24 bytes gmem
ptxas info    : Compiling entry function '_Z6fast_kPKfPf' for 'sm_90a'
ptxas info    : Function properties for _Z6fast_kPKfPf
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z6slow_kPKfPf' for 'sm_90a'
ptxas info    : Function properties for _Z6slow_kPKfPf
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""

SASS = """\
\t\tFunction : _Z6slow_kPKfPf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
                                                                     /* 0x000e220000000800 */
        /*0010*/                   LDG.E R2, desc[UR4][R2.64] ;      /* 0x0000000402027981 */
        /*0020*/              @!P0 STG.E desc[UR4][R4.64], R2 ;      /* 0x0000000204007986 */
        /*0030*/                   EXIT ;                            /* 0x000000000000794d */
\t\tFunction : _Z6fast_kPKfPf
        /*0000*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;  /* 0x0 */
        /*0010*/                   MUFU.EX2 R6, R6 ;                 /* 0x0 */
        /*0020*/                   CALL.REL.NOINC 0x2110 ;           /* 0x0 */
        /*0030*/               @P1 STG.E.128 desc[UR4][R8.64], R4 ;  /* 0x0 */
        /*0040*/                   STG.E desc[UR4][R8.64], R4 ;      /* 0x0 */
        /*0050*/                   EXIT ;                            /* 0x0 */
"""


def test_summarize_listing_reads_registers_and_opcodes():
    rows = {r["function"]: r for r in
            kernel_ab.summarize_listing(PTXAS, SASS)}
    assert set(rows) == {"_Z6fast_kPKfPf", "_Z6slow_kPKfPf"}
    fast, slow = rows["_Z6fast_kPKfPf"], rows["_Z6slow_kPKfPf"]
    assert (fast["registers"], fast["spill_stores"], fast["spill_loads"]) \
        == (30, 0, 0)
    assert (slow["registers"], slow["spill_stores"], slow["spill_loads"]) \
        == (128, 8, 12)
    assert fast["instructions"] == 6 and slow["instructions"] == 4
    assert fast["stores"] == {"STG.E.128": 1, "STG.E": 1}
    assert fast["loads"] == {"LDG.E.128.CONSTANT": 1}
    assert (fast["calls"], fast["mufu"]) == (1, 1)
    assert slow["stores"] == {"STG.E": 1} and slow["loads"] == {"LDG.E": 1}
    assert (slow["calls"], slow["mufu"]) == (0, 0)


LOOPS = """\
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0020*/                   FADD R3, R3, R2 ;
        /*0030*/               @P0 BRA `(.L_x_0) ;
        /*0040*/                   BRA `(.L_x_1) ;
        /*0050*/                   NOP ;
.L_x_1:
        /*0060*/                   ISETP.GE.AND P1, PT, R4, 0x10, PT ;
        /*0070*/              @!P1 BRA 0x0 ;
        /*0080*/                   EXIT ;
        /*0090*/                   BRA 0x90 ;
"""


def test_sass_loops_counts_each_backward_branch():
    """A branch back to a label or an address closes a loop; a forward
    branch and the padding branch to itself do not."""
    assert kernel_ab.sass_loops(LOOPS) == [3, 8]
    rows = kernel_ab.summarize_listing("", "\t\tFunction : k\n" + LOOPS)
    assert rows[0]["loops"] == [3, 8]


def test_digest_follows_the_sources(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    assert _build._digest(copy) == _build._digest()
    (copy / "reparam.cu").write_text((copy / "reparam.cu").read_text()
                                     + "\n// edited\n")
    assert _build._digest(copy) != _build._digest()
    (copy / "reparam.cu").write_text(
        (_build.CSRC / "reparam.cu").read_text())
    (copy / "common.cuh").write_text((copy / "common.cuh").read_text()
                                     + "\n")
    assert _build._digest(copy) != _build._digest()   # headers count too


def test_build_of_another_checkout_needs_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("the CUDA toolkit is installed: nvcc would be found")
    out = tmp_path / "build"
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(_build.CSRC, out)
    assert not out.exists()
    assert _build.build_seconds is None


def test_kernel_ab_needs_the_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the comparison runs")
    assert kernel_ab.main(["--parent", str(tmp_path)]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_kernel_ab_takes_the_parents_own_signatures(tmp_path):
    """A parent checkout's library is loaded with the signatures of that
    checkout's ``_build.py``, which may differ from this one's (an entry
    point that gained an argument)."""
    assert kernel_ab.parent_signatures(ROOT) == _build.SIGNATURES
    ops = tmp_path / "apv_tpu_torch" / "ops"
    ops.mkdir(parents=True)
    (ops / "_build.py").write_text(
        "import ctypes\n"
        "SIGNATURES = {'apv_groupnorm_gelu_bwd': (ctypes.c_void_p,) * 11\n"
        "              + (ctypes.c_int64,) * 4 + (ctypes.c_int,\n"
        "                                         ctypes.c_void_p)}\n")
    older = kernel_ab.parent_signatures(tmp_path)
    assert list(older) == ["apv_groupnorm_gelu_bwd"]
    new = _build.SIGNATURES["apv_groupnorm_gelu_bwd"]
    assert len(new) == len(older["apv_groupnorm_gelu_bwd"]) + 1
    assert new[-2] is ctypes.POINTER(ctypes.c_int)


def test_sources_hold_every_kernel_named_for_the_card():
    """Every function that ``chip_smoke.KERNEL_FNS`` looks for in a
    profile, and every one that a ``kernel_ab.CASES`` row times, is a
    ``__global__`` of ``ops/csrc`` (a renamed kernel would otherwise show
    up on the card as zero launches or an empty profile)."""
    kernels = _globals()
    assert {"groupnorm_gelu_image", "bernoulli_bwd_elems"} <= kernels
    named = {fn for fns in chip_smoke.KERNEL_FNS.values() for fn in fns}
    assert named <= kernels, named - kernels
    assert set(chip_smoke.KERNEL_FNS) == set(chip_smoke.REPLACES)
    for case in kernel_ab.CASES:
        main, beside = case.functions
        assert set(beside) <= kernels, case
        # the main function: either name, since the parent may hold the
        # other; this tree must hold one of them
        assert set(main) & kernels, case
        assert (_build.CSRC / case.source).exists()


def test_entry_points_match_their_ctypes_signatures():
    """Each ``extern "C"`` entry point takes as many parameters as
    ``_build.SIGNATURES`` gives it (a missed out-parameter would shift the
    stream into it on the card)."""
    entries = _entry_points()
    assert set(entries) == set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        assert entries[name] == len(argtypes), name
    gn = _build.SIGNATURES["apv_groupnorm_gelu"]
    assert gn[-2] is ctypes.POINTER(ctypes.c_int)
