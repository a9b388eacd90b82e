"""The conv probe's kernel function against the TPU kernel it replaces.

``scripts/conv_microbench.py::pallas_conv`` (loaded by path; run in
Pallas interpret mode, its own default off the TPU) is held to
``K.conv3x3_plain`` and ``conv_probe.conv3x3`` on CPU tensors, f32 and
bf16 inputs with f32 out, 1e-5 of max |ref|, at shapes that reach the
tensor-core kernel's tiling edges. The wrapper's routing rule and the
f32 kernel's K-major weight are checked here too; the CUDA kernels
themselves run only on the card (``chip_smoke.py``).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apv_tpu_torch.ops import conv_probe
from apv_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

MICROBENCH = Path(__file__).resolve().parents[1] / "scripts" / \
    "conv_microbench.py"

# (B, H, W, Cin, Cout), tile_b: a small square case, the tensor-core
# route's odd shape (Cin 24: a zero-filled K block; Cout 40: a partial N
# tile), the SIMT route's (Cin 13, Cout 20), and the tensor-core kernel's
# tiling edges (72 channels: a second, partial K block in bf16; 3 images
# in pixel boxes of 2; a row of 130 in boxes of 128)
SHAPES = [((4, 6, 5, 8, 16), 4), ((2, 9, 11, 24, 40), 2),
          ((3, 7, 5, 13, 20), 3), ((1, 5, 3, 72, 16), 1),
          ((3, 8, 8, 16, 8), 3), ((1, 2, 130, 8, 8), 1)]


@pytest.fixture(scope="module")
def microbench():
    spec = importlib.util.spec_from_file_location("conv_microbench",
                                                  MICROBENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(shape, seed=0):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)
    return x, wt


def _scale_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,tile_b", SHAPES)
def test_conv3x3_vs_pallas_conv(microbench, shape, tile_b, dtype):
    """The port's plain version and the probe's ``conv3x3`` (plain on the
    CPU) equal the Pallas kernel's output: same rounded inputs, f32
    products and sums, f32 out."""
    x, wt = _inputs(shape)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    ref = np.asarray(microbench.pallas_conv(jnp.asarray(x, jdt),
                                            jnp.asarray(wt, jdt),
                                            tile_b=tile_b))
    assert ref.dtype == np.float32 and ref.shape == shape[:3] + shape[4:]
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(wt).to(tdt)
    for got in (K.conv3x3_plain(tx, tw), conv_probe.conv3x3(tx, tw)):
        assert got.dtype == torch.float32
        assert _scale_rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("cin,cout,route", [
    (64, 64, "wgmma"), (128, 128, "wgmma"), (256, 256, "wgmma"),
    (24, 40, "wgmma"), (8, 8, "wgmma"), (72, 16, "wgmma"), (13, 20, "simt"),
    (16, 12, "simt"), (3, 64, "simt")])
def test_conv3x3_route(cin, cout, route):
    """Tensor cores for Cin and Cout multiples of 8, the SIMT kernel for
    the rest."""
    assert K.conv3x3_route(cin, cout) == route


def test_conv3x3_kmajor_layout():
    """Row n of the K-major weight (the f32 kernel's B) is Wf[:, n], k =
    (ky·3 + kx)·Cin + ci."""
    _, wt = _inputs((1, 1, 1, 8, 16))
    km = K.conv3x3_kmajor(torch.from_numpy(wt)).numpy()
    assert km.shape == (16, 72)
    for ky, kx, ci, n in [(0, 0, 0, 0), (1, 2, 5, 9), (2, 1, 7, 15)]:
        assert km[n, (ky * 3 + kx) * 8 + ci] == wt[ky, kx, ci, n]
