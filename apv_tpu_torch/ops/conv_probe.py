"""Conv probe: can a hand-written kernel beat the library's conv at the
flagship's shapes? (counterpart of ``scripts/conv_microbench.py``)

    python -m apv_tpu_torch.ops.conv_probe        # on the CUDA card

Three contenders per shape, forward pass, float32 and bfloat16:

* ``torch_conv``: ``F.conv2d`` on channels_last tensors (cuDNN; the
  library call the kernel is compared with);
* ``nine_dot``: the same conv as nine shifted matmuls accumulated in the
  input's dtype (the reference's XLA-dots reformulation);
* ``conv3x3``: the hand-written implicit-GEMM kernel
  (``ops/csrc/conv3x3.cu``), f32 accumulation and f32 out: ``wgmma`` on
  the tensor cores at the probe's widths (bf16, or 3xTF32 for f32), f32
  FMAs for widths that are not multiples of 8 (``K.conv3x3_route``); on
  CPU tensors its plain version ``conv3x3_plain``.

Shapes are the flagship ResNet VAE's three stages at batch 256. Prints
one JSON line per (shape, impl, dtype) with the chained time per conv, the
rate, and the error against the float32 ``F.conv2d`` (TF32 off).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from apv_tpu_torch.ops import kernels as K
from apv_tpu_torch.ops.dispatch import _on_cpu
from apv_tpu_torch.utils.device import resolve_device

SHAPES = [          # (B, H, W, Cin, Cout) — flagship stages at batch 256
    (256, 32, 32, 64, 64),
    (256, 16, 16, 128, 128),
    (256, 8, 8, 256, 256),
]


def torch_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC x, HWIO w -> NHWC out in x's dtype through ``F.conv2d``."""
    xn = x.permute(0, 3, 1, 2)                   # channels_last NCHW view
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return F.conv2d(xn, wn, padding=1).permute(0, 2, 3, 1)


def nine_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The conv as nine shifted [B·H·W, Cin] × [Cin, Cout] matmuls summed
    in x's dtype (the reference's ``nine_dot``)."""
    b, h, wd, c = x.shape
    k = w.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.zeros((b, h, wd, k), dtype=x.dtype, device=x.device)
    for ky in range(3):
        for kx in range(3):
            patch = xp[:, ky:ky + h, kx:kx + wd, :].reshape(-1, c)
            out = out + (patch @ w[ky, kx]).reshape(b, h, wd, k)
    return out


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 SAME stride-1 conv, NHWC x and HWIO w (bf16 or f32) -> f32 out:
    the kernel on CUDA tensors, its plain version on CPU tensors."""
    if _on_cpu("conv3x3", x, w):
        return K.conv3x3_plain(x, w)
    return K.conv3x3_cuda(x.contiguous(), w.contiguous())


IMPLS = (("torch_conv", torch_conv), ("nine_dot", nine_dot),
         ("conv3x3", conv3x3))


def bench_chained(fn, x: torch.Tensor, w: torch.Tensor, *, n_iter: int = 50,
                  windows: int = 5, reps: int = 4) -> float:
    """Seconds per conv, best window: Cin == Cout and SAME padding keep the
    shape, so ``n_iter`` convs chain back to back on the card (each output
    cast to x's dtype feeds the next), timed with CUDA events."""
    def many(xc):
        for _ in range(n_iter):
            xc = fn(xc, w).to(x.dtype)
        return xc

    many(x)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            many(x)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best / (reps * n_iter)


def run(shapes=None, *, device=None, seed: int = 0,
        **bench) -> list[dict]:
    """The probe's records, one per (shape, impl, dtype), on ``device``
    (``None``: the CUDA card; it raises without one). ``shapes`` defaults
    to ``SHAPES``; ``bench`` goes to ``bench_chained`` (n_iter, windows,
    reps)."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed)
    records = []
    for b, h, wd, cin, cout in (SHAPES if shapes is None else shapes):
        xf = torch.from_numpy(rng.normal(size=(b, h, wd, cin)).astype(
            np.float32)).to(device)
        wf = torch.from_numpy((rng.normal(size=(3, 3, cin, cout)) * 0.05)
                              .astype(np.float32)).to(device)
        with torch.inference_mode():
            ref = torch_conv(xf, wf).to(torch.float32)
            flops = 2 * b * h * wd * 9 * cin * cout
            for dtype in (torch.float32, torch.bfloat16):
                x, w = xf.to(dtype), wf.to(dtype)
                for name, fn in IMPLS:
                    got = fn(x, w).to(torch.float32)
                    err = float((got - ref).abs().max() / ref.abs().max())
                    sec = bench_chained(fn, x, w, **bench)
                    records.append({
                        "shape": [b, h, wd, cin, cout], "impl": name,
                        "dtype": str(dtype).removeprefix("torch."),
                        "chained_ms": sec * 1e3,
                        "tflops": flops / sec / 1e12,
                        "rel_err_vs_f32": err})
    return records


def main() -> int:
    for rec in run():
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
