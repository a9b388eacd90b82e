"""Data parallelism across cards (counterpart of ``apv_tpu/parallel/``):
process groups and their collectives (``multihost``), rank grids
(``mesh``) and the CPU dry run of every parallel path (``dryrun``)."""

from apv_tpu_torch.parallel.mesh import RankGrid, make_grid_2d  # noqa: F401
from apv_tpu_torch.parallel.multihost import (  # noqa: F401
    host_shard, init_group, initialize_from_env, local_rows,
    process_count, process_index, put_batch, round_global_batch)
