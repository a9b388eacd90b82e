"""Input preprocessing of the scoring path (counterpart of
``apv_tpu/data/preprocess.py:85-102``)."""

from __future__ import annotations

import numpy as np


def to_unit_interval(images_u8: np.ndarray) -> np.ndarray:
    """uint8 levels -> bin centers i/255 in [0,1] (discretized-logistic grid)."""
    return images_u8.astype(np.float32) / 255.0


def normalize_center(x):
    """[0,1] -> [-1,1]; works on numpy arrays and torch tensors alike."""
    return x * 2.0 - 1.0
