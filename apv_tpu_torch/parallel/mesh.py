"""Rank grids (counterpart of ``apv_tpu/parallel/mesh.py`` and of the 2-D
mesh of ``apv_tpu/eval/sharded.py``).

Training's 1-D ``data`` axis is the whole process group: each rank runs
its rows of the global batch, the parameters replicated, and the step
averages over the default group. The k-sharded IWAE lays ``n_data × n_k``
ranks out row-major, rank = d·n_k + k, as ``make_mesh_2d`` reshapes its
devices; each data row of ranks shares one k-group, the ranks that merge
their sample shards. Nothing reduces over a data column (the scores are
gathered over the whole group, so every rank holds them), so the grid
makes no data groups. Ranks past ``n_data·n_k`` take no part, as the
reference's mesh takes the first devices.

``dist.new_group`` is collective: every rank creates every group of a
grid, in the same order, so every rank must build the same grids in the
same order. Grids are cached by shape and group, so a second evaluation
makes no new groups.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch.distributed as dist

from apv_tpu_torch.parallel import multihost

class RankGrid(NamedTuple):
    n_data: int
    n_k: int
    data_index: int          # this rank's row, or -1 outside the grid
    k_index: int             # this rank's column, or -1 outside the grid
    k_group: Any             # the ranks of this row (None without a group)

    @property
    def member(self) -> bool:
        return self.data_index >= 0


_GRIDS: dict[tuple, RankGrid] = {}


def make_grid_2d(n_data: int, n_k: int) -> RankGrid:
    """The ``n_data × n_k`` grid over the first ``n_data·n_k`` ranks."""
    world = multihost.process_count()
    if n_data < 1 or n_k < 1:
        raise ValueError(f"bad grid {n_data} x {n_k}")
    if n_data * n_k > world:
        raise ValueError(f"need {n_data * n_k} ranks, have {world}")
    # by the group too: a new group (after a re-init) makes new groups
    key = (n_data, n_k, dist.group.WORLD if multihost.active() else None)
    if key in _GRIDS:
        return _GRIDS[key]
    rank = multihost.process_index()
    inside = rank < n_data * n_k
    d, k = (rank // n_k, rank % n_k) if inside else (-1, -1)
    k_group = None
    if multihost.active():
        # every rank makes every row's group, in one order
        rows = [dist.new_group([r * n_k + j for j in range(n_k)])
                for r in range(n_data)]
        if inside:
            k_group = rows[d]
    grid = RankGrid(n_data, n_k, d, k, k_group)
    _GRIDS[key] = grid
    return grid
