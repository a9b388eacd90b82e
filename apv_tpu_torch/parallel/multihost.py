"""Process groups across cards (counterpart of
``apv_tpu/parallel/multihost.py``).

One process per card, in the torch idiom: every process joins one
``torch.distributed`` group before it touches a card, pins the card of its
rank, cuts only its own rows of each global batch (``Batcher(host_shard=
...)``) and runs the same step; the step averages its gradients over the
group (``average_``) where XLA inserts the all-reduce in the reference,
which runs one process per host that owns all the host's chips.

Env contract (set by the launcher), as the reference's:

  APV_COORDINATOR   host:port of process 0 (required to opt in)
  APV_NUM_PROCESSES total process count
  APV_PROCESS_ID    this process's rank

Without a group every function here is the single-process identity, so
the one-card path is unchanged. A group of one runs its collectives, which
leave every value as it was.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist


def init_group(rank: int, world: int, init_method: str, *,
               device: str | torch.device = "cuda",
               backend: str | None = None) -> None:
    """Join the group of ``world`` processes as ``rank``: ``nccl`` on a
    CUDA device, ``gloo`` on the CPU (``backend`` names another, as two
    ranks sharing one card do). On CUDA the rank's card is pinned first:
    ``rank % device_count``."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_group: a CUDA group was asked for and "
                               "no CUDA device is available")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)


def initialize_from_env(*, device: str | torch.device = "cuda",
                        backend: str | None = None) -> bool:
    """``init_group`` over ``tcp://$APV_COORDINATOR`` from the APV_* env
    vars; returns whether a group was joined (False when APV_COORDINATOR
    is unset). Must run before anything touches the card."""
    coord = os.environ.get("APV_COORDINATOR")
    if not coord:
        return False
    init_group(int(os.environ["APV_PROCESS_ID"]),
               int(os.environ["APV_NUM_PROCESSES"]), f"tcp://{coord}",
               device=device, backend=backend)
    return True


def active() -> bool:
    """Whether this process is in a group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if active() else 0


def process_count() -> int:
    return dist.get_world_size() if active() else 1


def host_shard() -> tuple[int, int] | None:
    """``Batcher(host_shard=...)`` spec for this process: (rank, world)
    under a group of more than one, else None. The one owner of the
    contract that the train and eval batch loops share."""
    if process_count() == 1:
        return None
    return (process_index(), process_count())


def round_global_batch(bs: int, pcount: int | None = None,
                       n_shards: int = 1) -> int:
    """Largest multiple of lcm(``pcount``, ``n_shards``) ≤ ``bs``, floored
    at one such multiple: a global batch that splits evenly over the
    processes and over the data shards. ``pcount`` defaults to the group's
    size. The one owner of this rounding rule."""
    pcount = process_count() if pcount is None else pcount
    div = math.lcm(pcount, n_shards)
    if div == 1:
        return bs
    return max(div, (bs // div) * div)


def local_rows(n_global: int, pid: int | None = None,
               pcount: int | None = None) -> tuple[int, int]:
    """[start, stop) of this process's contiguous rows of a global batch,
    which must divide evenly."""
    pid = process_index() if pid is None else pid
    pcount = process_count() if pcount is None else pcount
    if n_global % pcount != 0:
        raise ValueError(f"global batch {n_global} not divisible by "
                         f"{pcount} processes")
    per = n_global // pcount
    return pid * per, (pid + 1) * per


def put_batch(batch: dict[str, np.ndarray],
              device: str | torch.device) -> dict[str, torch.Tensor]:
    """This process's rows (numpy) to its device."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def comm_device() -> torch.device:
    """Where this group's collectives take their tensors: the pinned card
    under NCCL, the CPU otherwise (gloo also carries CUDA tensors in
    ``all_reduce`` and ``broadcast``)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def agree_max(value: int | None) -> int | None:
    """Collective max of a per-process optional int (None = absent); the
    single-process identity. For decisions made from what a process sees
    on its disk (the stale-run refusal): only process 0 writes, so on
    storage that is not shared only process 0 may see the stale step, and
    a decision of its own would leave the others blocking."""
    if process_count() == 1:
        return value
    t = torch.tensor([-1 if value is None else value], dtype=torch.int64,
                     device=comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    m = int(t.item())
    return None if m < 0 else m


def average_(tensors: list[torch.Tensor], group=None) -> None:
    """Average ``tensors`` over ``group`` (default: the whole group) in
    place, through one flattened float32 bucket and one ``all_reduce``."""
    if not tensors or not active():
        return
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM,
               group=None) -> torch.Tensor:
    """``t`` reduced over ``group`` with ``op``, returned on ``t``'s device
    (through the CPU under gloo, which reduces CUDA tensors only by
    sum)."""
    if dist.get_backend(group) == "nccl" or t.device.type == "cpu":
        dist.all_reduce(t, op=op, group=group)
        return t
    host = t.cpu()
    dist.all_reduce(host, op=op, group=group)
    return host.to(t.device)


def group_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the group, as a new tensor (``t`` itself
    without a group)."""
    if not active():
        return t
    out = t.detach().to(torch.float32).clone()
    average_([out])
    return out.to(t.dtype)


class _GroupMean(torch.autograd.Function):
    """Forward: the group mean of a batch statistic; backward: the
    gradient passed to the local statistic unchanged, so the gradients
    averaged over the group are those of the global statistic."""

    @staticmethod
    def forward(ctx, t):
        return group_mean(t)

    @staticmethod
    def backward(ctx, g):
        return g


def group_batch_mean(t: torch.Tensor) -> torch.Tensor:
    """``t``, a mean over this rank's rows, as the global batch's mean
    (``t`` itself without a group)."""
    return _GroupMean.apply(t) if active() else t


def broadcast_(tensors: list[torch.Tensor], src: int = 0) -> None:
    """Copy process ``src``'s ``tensors`` into every process's, in place:
    one flattened bucket a dtype, one ``broadcast`` each."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src)
        off = 0
        with torch.no_grad():
            for t in ts:
                n = t.numel()
                t.copy_(flat[off:off + n].view(t.shape))
                off += n


def broadcast_ints(values: list[int], src: int = 0) -> list[int]:
    """Process ``src``'s ints, on every process."""
    t = torch.tensor(values, dtype=torch.int64, device=comm_device())
    dist.broadcast(t, src)
    return [int(v) for v in t.tolist()]


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's equal-length ``t`` [n, ...] stacked in rank order
    -> [world·n, ...], on ``t``'s device."""
    size = dist.get_world_size(group)
    src = t.contiguous()
    if dist.get_backend(group) != "nccl":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def barrier() -> None:
    """Wait for every process of the group (no-op without one)."""
    if active():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
