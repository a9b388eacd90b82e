"""What the work is, counted from a configuration's shapes, never from what
the program launches.

Model FLOPs come from the benchmark's own reference networks, traced on
the meta device under ``torch.utils.flop_counter.FlopCounterMode`` (two
operations a multiply-add of every matmul and convolution; elementwise
work is not counted, so a share of a peak built on these is a lower
bound):

* a train step, an image: encoder and decoder forward once and backward
  twice (no gradient of the stem's input, the data), the latent D forward
  and its input's gradient in the G phase, and in the D phase D forward on
  the posterior and the prior sample and its weights' gradient;
* an IWAE-k score, an image: the encoder once and the decoder and D k
  times. The estimate of log Z is left out.

The bytes and operations of one launch of a port kernel (``kernel_work``)
count each input read once and each output written once, whatever the
kernel reads again (an image scored under S samples is read once); the
operations are those of the function, per element, each transcendental
one, on the float32 units outside the tensor cores.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import models

# Operations an element (an output element of a reduction's input):
# disc_logistic ~8 transcendentals and ~22 adds, multiplies and compares;
# reparam 10 Philox rounds of ~10 integer operations per 4 draws,
# Box-Muller and the affine; kl 2 transcendentals and 4 arithmetic;
# bernoulli exp, log1p, max, abs, a multiply and two adds; the backward
# kernels 5 (reparam_bwd a sample), 5 (kl_bwd), 30 (disc_logistic_bwd: 4
# exp, 3 divides, ~23 others).
OPS_PER_ELEM = {"disc_logistic": 30, "reparam": 33, "kl": 6, "bernoulli": 7,
                "reparam_bwd": 5, "kl_bwd": 5, "disc_logistic_bwd": 30,
                "bernoulli_bwd": 5}

# Each port kernel's function name in ``apv_tpu_torch/ops/csrc``, as the
# device trace names it.
KERNEL_FUNCTIONS = {"reparam": "reparam_samples",
                    "reparam_bwd": "reparam_bwd_sum",
                    "disc_logistic": "disc_logistic_rows",
                    "disc_logistic_bwd": "disc_logistic_bwd_rows",
                    "bernoulli": "bernoulli_rows",
                    "bernoulli_bwd": "bernoulli_bwd_elems",
                    "kl": "kl_rows", "kl_bwd": "kl_bwd_rows"}


def kernel_work(name: str, **s) -> tuple[int, int]:
    """(bytes, operations) of one launch of kernel ``name`` at shapes
    ``s``: ``samples``, ``n`` (B·Z), ``rows`` (B) and ``kl`` for the
    reparam kernels; ``rows`` (R), ``event`` (E) and ``x_rows`` for the
    likelihoods."""
    if name == "reparam":
        S, n, b, kl = s["samples"], s["n"], s["rows"], s["kl"]
        return (4 * (2 * n + S * n + (b if kl else 0)),
                OPS_PER_ELEM["reparam"] * S * n
                + (OPS_PER_ELEM["kl"] * n if kl else 0))
    if name == "reparam_bwd":
        S, n, b, kl = s["samples"], s["n"], s["rows"], s["kl"]
        if kl:      # g, z; mean, logvar, g_kl; dmean, dlogvar
            return (4 * (2 * S * n + 2 * n + b + 2 * n),
                    OPS_PER_ELEM["reparam_bwd"] * S * n
                    + (OPS_PER_ELEM["kl_bwd"] + 2) * n)
        return 4 * (2 * S * n + n + 2 * n), OPS_PER_ELEM["reparam_bwd"] * S * n
    r, e = s["rows"], s["event"]
    if name == "disc_logistic":      # mean, log_scale; x once an image
        return 4 * (2 * r * e + s["x_rows"] * e + r), 30 * r * e
    if name == "disc_logistic_bwd":  # g; x, mean, log_scale; dmean, dls
        return 4 * (r + 3 * r * e + 2 * r * e), 30 * r * e
    if name == "bernoulli":
        return 4 * (r * e + s["x_rows"] * e + r), 7 * r * e
    raise ValueError(f"no work reckoned for kernel {name!r}")


def least_seconds(nbytes: int, ops: int, bytes_per_s: float,
                  ops_per_s: float) -> float:
    return max(nbytes / bytes_per_s, ops / ops_per_s)


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def forward_flops(cfg: dict) -> dict[str, int]:
    """FLOPs of one image's encoder, decoder, stem and latent D forward,
    at the configuration's widths, on the meta device."""
    m = cfg["model"]
    h, w, c = m["image_shape"]
    with torch.device("meta"):
        vae = models.build_vae(m)
        x = torch.empty(1, h, w, c)
        z = torch.empty(1, m["z_dim"])
        out = {"encoder": _flops(lambda: vae.encode(x)),
               "decoder": _flops(lambda: vae.decode(z)),
               "stem": _flops(lambda: vae.encoder.stem(
                   x.permute(0, 3, 1, 2))) if hasattr(vae.encoder, "stem")
               else _flops(lambda: vae.encoder.convs[0](
                   x.permute(0, 3, 1, 2))),
               "d": 0}
        if cfg.get("adversarial", {}).get("enabled"):
            d = models.build_latent_d(cfg)
            out["d"] = _flops(lambda: d(z))
    return out


def train_flops_per_image(cfg: dict) -> int:
    f = forward_flops(cfg)
    vae = 3 * (f["encoder"] + f["decoder"]) - f["stem"]
    return vae + 2 * f["d"] + 4 * f["d"]


def iwae_flops_per_image(cfg: dict, k: int) -> int:
    f = forward_flops(cfg)
    return f["encoder"] + k * (f["decoder"] + f["d"])
