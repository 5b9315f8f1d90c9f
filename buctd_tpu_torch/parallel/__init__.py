"""Multi-card runs (buctd_tpu/parallel/): the process group and the mesh."""

from .distributed import initialize_distributed, is_primary, process_shard
from .mesh import allgather_rows, host_local_rows, make_mesh, replicate, shard_batch

__all__ = ["make_mesh", "shard_batch", "replicate", "host_local_rows", "allgather_rows",
           "initialize_distributed", "is_primary", "process_shard"]
