"""bits/dim conversion (counterpart of ``apv_tpu/core/metrics.py``)."""

from __future__ import annotations

import math


def nats_to_bits_per_dim(nll_nats, num_dims: int):
    """NLL in nats -> bits per dimension, NLL / (D · ln 2).

    The discretized-logistic likelihood is already a discrete pmf over the
    256 bins, so no dequantization correction applies.
    """
    return nll_nats / (num_dims * math.log(2.0))
