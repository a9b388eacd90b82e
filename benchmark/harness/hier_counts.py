"""What the hierarchical family's work is, counted from a configuration's
shapes (as ``counts.py`` counts the flagship's), never from what the
program launches.

* Model FLOPs: the reference VDVAE (``reference/vdvae.py``) traced on the
  meta device under ``FlopCounterMode`` (two operations a multiply-add of
  every convolution; elementwise work not counted). A train step, an
  image: forward once and backward twice, less the input conv's gradient
  of its input (the data).
* The reparam kernel's learned-prior variant, one layer of z [B, Z, r, r]
  (n = B·Z·r·r elements): forward, q and p read once (4n floats) and z and
  the per-image KL written (n + B), with the sampling's operations
  (``counts.OPS_PER_ELEM["reparam"]``) and the KL's, 3 transcendentals and
  9 arithmetic an element; backward, g, z, q and p read (6n) and the
  per-image KL's gradient (B), dq and dp written (4n), 3 transcendentals
  and 16 arithmetic an element.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness.counts import OPS_PER_ELEM
from benchmark.reference import vdvae

PRIOR_KL_OPS = 12         # ops an element of the KL to a learned prior
PRIOR_BWD_OPS = 19        # ops an element of the variant's backward


def layer_shapes(model_cfg: dict, batch: int) -> list[tuple[int, ...]]:
    """z's shape [B, Z, r, r] in each decoder layer, in order."""
    z = model_cfg["z_dim"]
    return [(batch, z, r, r) for r, _ in
            vdvae.parse_blocks(model_cfg["dec_blocks"])]


def prior_kernel_work(shape: tuple[int, ...]) -> dict[str, tuple[int, int]]:
    """{kernel: (bytes, operations)} of one layer's launch each way."""
    b = shape[0]
    n = b * shape[1] * shape[2] * shape[3]
    return {"reparam": (4 * (5 * n + b),
                        (OPS_PER_ELEM["reparam"] + PRIOR_KL_OPS) * n),
            "reparam_bwd": (4 * (10 * n + b), PRIOR_BWD_OPS * n)}


def step_kernels(model_cfg: dict, batch: int) -> dict[str, dict]:
    """The port kernels of one train step: name -> {"launches", "bytes",
    "ops"} summed over the layers."""
    out = {k: {"launches": 0, "bytes": 0, "ops": 0}
           for k in ("reparam", "reparam_bwd")}
    for shape in layer_shapes(model_cfg, batch):
        for name, (nbytes, ops) in prior_kernel_work(shape).items():
            out[name]["launches"] += 1
            out[name]["bytes"] += nbytes
            out[name]["ops"] += ops
    return out


def train_flops_per_image(cfg: dict) -> int:
    m = cfg["model"]
    h, w, c = m["image_shape"]
    with torch.device("meta"):
        net = vdvae.VDVAE(m, vdvae.Precision())
        x = torch.empty(1, h, w, c)
        eps = [torch.empty(s) for s in net.layer_shapes(1)]
        with FlopCounterMode(display=False) as counter:
            net(x, x, eps)
        whole = int(counter.get_total_flops())
        with FlopCounterMode(display=False) as counter:
            net.encoder.in_conv(x.permute(0, 3, 1, 2))
        stem = int(counter.get_total_flops())
    return 3 * whole - stem
