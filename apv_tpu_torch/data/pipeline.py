"""Host batching (counterpart of ``apv_tpu/data/pipeline.py``): shuffled
epochs over in-memory numpy arrays, the same permutations from the same
seed as the reference's ``Batcher``, and grouping into k-step stacks.

Single host, from the first batch: the reference's multi-host row
sharding, its prefetch to the device and its fast-forward for resume
(``iter_from``) are not ported.
"""

from __future__ import annotations

import itertools
from typing import Iterable, Iterator

import numpy as np


class Batcher:
    """Shuffled epoch batching over in-memory numpy arrays (the
    reference's training defaults: shuffled, remainder dropped).

    Yields dict batches of equal ``batch_size``.
    """

    def __init__(self, arrays: dict[str, np.ndarray], batch_size: int, *,
                 seed: int = 0):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"array length mismatch: {sizes}")
        self.arrays = arrays
        self.n = next(iter(sizes.values()))
        if batch_size > self.n:
            raise ValueError(f"batch_size {batch_size} > dataset size {self.n}")
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

    @property
    def batches_per_epoch(self) -> int:
        return self.n // self.batch_size

    def epoch(self) -> Iterator[dict[str, np.ndarray]]:
        idx = np.arange(self.n)
        self._rng.shuffle(idx)
        stop = self.batches_per_epoch * self.batch_size
        for start in range(0, stop, self.batch_size):
            sel = idx[start:start + self.batch_size]
            yield {k: v[sel] for k, v in self.arrays.items()}

    def __iter__(self):
        """Infinite stream of batches across epochs (training)."""
        while True:
            yield from self.epoch()


def stack_batches(it: Iterable[dict[str, np.ndarray]],
                  k: int) -> Iterator[dict[str, np.ndarray]]:
    """Group k consecutive batches into one [k, B, ...] stack
    (``train.steps_per_call``), in the unstacked stream's order."""
    if k < 1:
        raise ValueError("k must be >= 1")
    it = iter(it)
    while True:
        group = list(itertools.islice(it, k))
        if len(group) < k:
            return
        yield {key: np.stack([b[key] for b in group]) for key in group[0]}
