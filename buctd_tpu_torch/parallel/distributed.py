"""Multi-process start-up: one process per card over ``torch.distributed``.

Counterpart of buctd_tpu/parallel/distributed.py.  JAX connects its hosts
with ``jax.distributed.initialize``; here every card is driven by its own
process, and ``initialize_distributed`` joins them into one process group:

  * ``--coordinator host:port --num-processes N --process-id R`` (the
    entry points' flags, as tools/train.py's) give ``tcp://host:port``, N
    and R;
  * without them, the ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
    ``WORLD_SIZE`` environment that ``torchrun`` sets (the counterpart of
    JAX's ``JAX_COORDINATOR_ADDRESS``) is read through ``env://``.

The backend is NCCL for processes on the card and gloo on the CPU;
``backend`` overrides it (two processes on one card must take gloo: NCCL
refuses two ranks on one GPU).  On the card the process's card,
``LOCAL_RANK`` or else the rank modulo the local card count, becomes the
current CUDA device before any CUDA work.  With NCCL a second group over
gloo carries the host arrays of the evaluation merge (parallel/mesh.py),
since NCCL takes no CPU tensors.

``utils/distributed.py::process_info`` stays the one reader of the rank and
the world size; ``is_primary`` and ``process_shard`` are built on it.
"""

from __future__ import annotations

import logging
import os

import torch

from ..utils import distributed

logger = logging.getLogger(__name__)

_STATE = {"device": None, "host_group": None}


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, device: str = "cuda",
                           backend: str | None = None) -> bool:
    """Join this process to the run's process group.

    Returns False in a single-process run (no flag and no ``torchrun``
    environment: nothing is started), True once the group exists (also when
    it existed already).  ``device`` is the type the process trains or
    evaluates on, "cuda" or "cpu".  A failed ``init_process_group`` raises;
    nothing falls back to one process."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and num_processes is None and process_id is None:
        if not ("MASTER_ADDR" in env and "WORLD_SIZE" in env and "RANK" in env):
            return False
        init_method, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("--coordinator, --num-processes and --process-id go "
                             "together (or none of them, under torchrun)")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside 0..{world - 1}")
    dev_type = torch.device(device).type
    if backend is None:
        backend = "nccl" if dev_type == "cuda" else "gloo"
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: CUDA is not available; pass "
                               "device='cpu' to run the processes on the CPU")
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        _STATE["device"] = torch.device("cuda", local)
    else:
        _STATE["device"] = torch.device("cpu")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    _STATE["host_group"] = (dist.new_group(backend="gloo")
                            if dist.get_backend() == "nccl" else None)
    logger.info("=> torch.distributed initialised: process %d/%d, %s on %s", rank, world,
                backend, _STATE["device"])
    return True


def process_device() -> torch.device | None:
    """The device ``initialize_distributed`` gave this process, or None."""
    return _STATE["device"]


def host_group():
    """The group host (CPU) tensors are gathered over: the gloo group beside
    NCCL, else the default group (None)."""
    return _STATE["host_group"]


def is_primary() -> bool:
    """True on process 0 (or in any single-process run).

    It gates what one process writes for all: the log file and the metric
    writer (utils/logging_utils.py) and the trainer's checkpoints
    (train/run.py).  Evaluation results and debug images are written by
    every process under its own tag (core/function.py)."""
    return distributed.process_info()[0] == 0


def process_shard(n: int) -> slice:
    """This process's contiguous shard of a length-n sample index space."""
    p, k = distributed.process_info()
    per = -(-n // k)
    return slice(p * per, min((p + 1) * per, n))


def shutdown_distributed() -> None:
    """Leave the process group ``initialize_distributed`` joined (a no-op
    where there is none)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, host_group=None)


def barrier() -> None:
    """Every process waits here for all the others; a no-op in one process."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
