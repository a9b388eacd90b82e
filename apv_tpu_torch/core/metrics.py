"""bits/dim conversion and active units (counterpart of
``apv_tpu/core/metrics.py``)."""

from __future__ import annotations

import math

import numpy as np


def nats_to_bits_per_dim(nll_nats, num_dims: int):
    """NLL in nats -> bits per dimension, NLL / (D · ln 2).

    The discretized-logistic likelihood is already a discrete pmf over the
    256 bins, so no dequantization correction applies.
    """
    return nll_nats / (num_dims * math.log(2.0))


def active_units(mean_batches, threshold: float = 1e-2):
    """Active latent units (IWAE paper, arXiv 1509.00519 §5.1): unit u is
    active if A_u = Cov_x(E_q[z_u | x]) > threshold, over ``mean_batches``
    of [B, Z] posterior means, in float64 streaming moments. Returns
    (count, per-unit variance [Z])."""
    n, s, s2 = 0, None, None
    for m in mean_batches:
        m = np.asarray(m, np.float64).reshape(m.shape[0], -1)
        if s is None:
            s, s2 = np.zeros(m.shape[1]), np.zeros(m.shape[1])
        n += m.shape[0]
        s += m.sum(axis=0)
        s2 += (m * m).sum(axis=0)
    if not n:
        raise ValueError("active_units: no posterior means supplied")
    var = s2 / n - (s / n) ** 2
    return int((var > threshold).sum()), var
