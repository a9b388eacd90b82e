"""k-sharded IWAE over a rank grid (counterpart of
``apv_tpu/eval/sharded.py``).

The k=1000 importance samples of an image are this workload's long axis.
On an ``n_data × n_k`` grid of ranks (``parallel/mesh.py``) each data row
of ranks scores one shard of the batch, and each of its n_k ranks streams
k/n_k of the samples in chunks; the running logsumexp states then merge
over the row's k-group with one MAX and one SUM ``all_reduce``, the
cross-rank form of the streaming fold (associative, so the merged value is
the estimator of one rank over all k, to float reassociation).

Noise: a batch's chunks draw from one CPU generator, one key a chunk
(``ops.reparam_sample``). k-shard i first skips the keys of the
i·(k/n_k/chunk) chunks before its own, so its draws are those of the
unsharded run's chunks, on the CPU and on the card alike. With more than
one data shard the data index is folded into the batch's seed, so the
shards draw independent noise; with one the stream is the unsharded one.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from apv_tpu_torch.core.iwae import LogSumExpState
from apv_tpu_torch.eval.iwae_eval import make_iwae_fn
from apv_tpu_torch.ops import kernels as K
from apv_tpu_torch.parallel import multihost
from apv_tpu_torch.parallel.mesh import RankGrid


def fold_seed(seed: int, data_index: int) -> int:
    """A batch's seed with a data shard's index folded in."""
    words = np.random.SeedSequence([seed, data_index]).generate_state(
        2, np.uint32)
    return ((int(words[0]) << 32) | int(words[1])) & (2 ** 63 - 1)


def merge_k_shards(state: LogSumExpState, k: int, group) -> torch.Tensor:
    """The k-shards' running states merged over ``group`` -> log p(x)
    estimates: the global max, each shard's sum rescaled to it (an empty
    shard, max −inf, adds 0), summed."""
    gmax = multihost.all_reduce(state.max.clone(), dist.ReduceOp.MAX, group)
    acc = state.acc * torch.exp(torch.where(torch.isfinite(state.max),
                                            state.max - gmax, -torch.inf))
    acc = multihost.all_reduce(acc, group=group)
    return gmax + torch.log(acc) - math.log(float(k))


def make_sharded_iwae_fn(model, likelihood: str, k: int, chunk: int,
                         grid: RankGrid, d_apply: Callable | None = None,
                         prior_logpdf_p: Callable | None = None,
                         prior_logpdf: Callable | None = None) -> Callable:
    """Build ``fn(x_in, x_target, log_z=0.0, *, seed, eps=None) -> [b]``
    for this rank's data shard of a batch (b rows); the priors as
    ``make_logw_chunk_fn``'s. ``k`` is the total sample count; each of the
    grid's n_k k-shards runs k/n_k of them, ``chunk`` at a time. ``seed``
    is the batch's; ``eps`` ([k/n_k/chunk, chunk, b, Z], CPU only) injects
    this shard's chunks' noise. Each shard runs ``make_iwae_fn`` over its
    k/n_k samples; with n_k == 1 nothing is merged and the result is the
    unsharded estimator's, bit for bit."""
    n_k = grid.n_k
    if k % (n_k * chunk) != 0:
        raise ValueError(f"k={k} must divide into n_k={n_k} shards of "
                         f"chunk={chunk}")
    n_local = k // n_k // chunk
    local_fn = make_iwae_fn(model, likelihood, k // n_k, chunk, d_apply,
                            prior_logpdf_p, prior_logpdf)

    def iwae_fn(x_in, x_target, log_z=0.0, *, seed: int, eps=None):
        if not grid.member:
            raise ValueError("this rank is outside the grid")
        gen = torch.Generator().manual_seed(
            seed if grid.n_data == 1 else fold_seed(seed, grid.data_index))
        for _ in range(grid.k_index * n_local):
            K.draw_key(gen)         # the chunk keys of the shards before
        out = local_fn(x_in, x_target, log_z, generator=gen, eps=eps,
                       finalize=n_k == 1)
        return out if n_k == 1 else merge_k_shards(out, k, grid.k_group)

    return iwae_fn
