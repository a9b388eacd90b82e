"""Host batching (counterpart of ``apv_tpu/data/pipeline.py``): epochs
over in-memory numpy arrays, shuffled with the same permutations from the
same seed as the reference's ``Batcher`` or in order (validation), the
resume fast-forward ``iter_from``, grouping into k-step stacks, and the
copy to the device ``depth`` batches ahead of the consumer.

Under a process group each rank's ``Batcher(host_shard=(rank, world))``
draws the same permutation and keeps its contiguous rows of each global
batch, so the ranks' batches concatenate to the one-process batch.
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator

import numpy as np
import torch

from apv_tpu_torch.parallel.multihost import local_rows


class Batcher:
    """Epoch batching over in-memory numpy arrays, shuffled (training) or
    in order (``shuffle=False``, validation); the remainder is dropped.

    Yields dict batches of equal ``batch_size``; with ``host_shard=(pid,
    pcount)`` the batch size stays the global one and each batch is cut to
    the process's ``batch_size // pcount`` contiguous rows.
    """

    def __init__(self, arrays: dict[str, np.ndarray], batch_size: int, *,
                 shuffle: bool = True, seed: int = 0,
                 host_shard: tuple[int, int] | None = None):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"array length mismatch: {sizes}")
        self.arrays = arrays
        self.n = next(iter(sizes.values()))
        if batch_size > self.n:
            raise ValueError(f"batch_size {batch_size} > dataset size {self.n}")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self.rows = slice(None)
        if host_shard is not None:
            pid, pcount = host_shard
            if not 0 <= pid < pcount:
                raise ValueError(f"bad host_shard {host_shard}")
            self.rows = slice(*local_rows(batch_size, pid, pcount))

    @property
    def batches_per_epoch(self) -> int:
        return self.n // self.batch_size

    def epoch(self, skip: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """One epoch's batches, from batch ``skip`` of it on."""
        idx = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(idx)
        stop = self.batches_per_epoch * self.batch_size
        for start in range(skip * self.batch_size, stop, self.batch_size):
            sel = idx[start:start + self.batch_size][self.rows]
            yield {k: v[sel] for k, v in self.arrays.items()}

    def __iter__(self):
        """Infinite stream of batches across epochs (training)."""
        while True:
            yield from self.epoch()

    def iter_from(self, start_batch: int) -> Iterator[dict[str, np.ndarray]]:
        """The infinite stream fast-forwarded to batch ``start_batch``, for
        an exact resume: each skipped epoch still draws its permutation, so
        the data order matches an uninterrupted run; skipped batches of the
        current epoch are not gathered."""
        bpe = self.batches_per_epoch
        for _ in range(start_batch // bpe):
            if self.shuffle:
                self._rng.shuffle(np.arange(self.n))
        yield from self.epoch(skip=start_batch % bpe)
        yield from self


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


def prefetch_to_device(it: Iterable[dict[str, np.ndarray]],
                       device: str | torch.device, depth: int = 2
                       ) -> Iterator[dict[str, torch.Tensor]]:
    """Copy the batches of ``it`` to ``device`` ``depth`` batches ahead of
    the consumer: on a CUDA device from pinned host memory with
    ``non_blocking=True``, so the copies of the next batches overlap the
    steps on the current one."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    dev = torch.device(device)
    pin = dev.type == "cuda"

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory().to(dev, non_blocking=True) if pin \
                else t.to(dev)
        return out

    queue: collections.deque = collections.deque()
    it = iter(it)
    for batch in itertools.islice(it, depth):
        queue.append(put(batch))
    while queue:
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(nxt))
        yield queue.popleft()
