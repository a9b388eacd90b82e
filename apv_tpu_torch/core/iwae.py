"""IWAE importance-weighted log-likelihood estimator (counterpart of
``apv_tpu/core/iwae.py``).

    log p(x) ≈ logsumexp_k [ log p(x, z_k) - log q(z_k | x) ] - log k

The k=1000 configuration cannot hold all k decoder activations at once, so
chunks of importance weights fold into a running (max, scaled-sum) state in
a Python loop over chunks. Chunking is exactly associative in this
representation, so chunked == unchunked to float tolerance.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from apv_tpu_torch.utils.logging import waits


class LogSumExpState(NamedTuple):
    """Running logsumexp over a streamed axis: value = max + log(acc)."""
    max: torch.Tensor    # running maximum of the stream
    acc: torch.Tensor    # sum of exp(w - max) seen so far
    count: int           # number of items folded in (for the -log k term)


def streaming_logsumexp_init(shape: tuple[int, ...],
                             device: torch.device | str = "cpu"
                             ) -> LogSumExpState:
    return LogSumExpState(
        max=torch.full(shape, -torch.inf, dtype=torch.float32, device=device),
        acc=torch.zeros(shape, dtype=torch.float32, device=device),
        count=0)


def streaming_logsumexp_update(state: LogSumExpState,
                               logw: torch.Tensor) -> LogSumExpState:
    """Fold a chunk of log-weights (chunk axis 0) into the running state."""
    logw = logw.to(torch.float32)
    new_max = torch.maximum(state.max, logw.amax(dim=0))
    # Rescale the old accumulator to the new max; a -inf running max has an
    # empty accumulator, so its scale is 0.
    old = state.acc * torch.where(torch.isfinite(state.max),
                                  torch.exp(state.max - new_max),
                                  torch.zeros_like(new_max))
    new = torch.exp(logw - new_max[None]).sum(dim=0)
    return LogSumExpState(max=new_max, acc=old + new,
                          count=state.count + logw.shape[0])


def streaming_logsumexp_finalize(state: LogSumExpState) -> torch.Tensor:
    """logsumexp - log(count): the IWAE average in log space (the count
    crosses from host memory: a synchronising copy on the card)."""
    with waits("upload"):
        count = torch.tensor(float(state.count), device=state.max.device)
    return state.max + torch.log(state.acc) - torch.log(count)


def iwae_log_likelihood(logw_fn: Callable[[int], torch.Tensor], k: int,
                        chunk_size: int, out_shape: tuple[int, ...],
                        device: torch.device | str = "cpu") -> torch.Tensor:
    """Estimate log p(x) with k importance samples, chunk_size at a time.

    ``logw_fn(i) -> [chunk_size, *out_shape]`` draws chunk ``i``'s fresh
    importance samples and returns log p(x, z) - log q(z|x). Peak memory is
    one chunk of decoder activations.
    """
    if k % chunk_size != 0:
        raise ValueError(f"k={k} must be divisible by chunk_size={chunk_size}")
    return streaming_logsumexp_finalize(
        iwae_stream(logw_fn, k // chunk_size, out_shape, device))


def iwae_stream(logw_fn: Callable[[int], torch.Tensor], n_chunks: int,
                out_shape: tuple[int, ...],
                device: torch.device | str = "cpu") -> LogSumExpState:
    """The running state after folding in chunks 0 .. ``n_chunks`` − 1 of
    ``logw_fn``, unfinalized: a k-shard's part of the estimator, which
    ``eval/sharded.py`` merges across ranks."""
    state = streaming_logsumexp_init(out_shape, device)
    for i in range(n_chunks):
        state = streaming_logsumexp_update(state, logw_fn(i))
    return state
