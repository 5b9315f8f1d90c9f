"""This process's place among the processes of a run.

``process_info`` is the one place the port reads it: the loaders' sharding
helpers (data/pipeline.py) and the logger (utils/logging_utils.py) call it
through this module, so a test patches it here.
"""

from __future__ import annotations


def process_info():
    """(process index, process count): ``torch.distributed``'s rank and world
    size where it is initialised, else (0, 1).  Nothing in the port starts
    more than one process yet (ROADMAP Queue 1 item 8, multi-card)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
