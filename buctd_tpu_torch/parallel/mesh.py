"""The mesh of cards a run spans, and moving rows and parameters over it.

Counterpart of buctd_tpu/parallel/mesh.py.  A JAX mesh lays every device of
every host out under named axes, and one program spans it.  Here each
process drives its own card(s), so a ``Mesh`` holds the devices THIS
process drives, the mesh shape and axis names, and ``size``: the devices of
the whole run (the world size times the local devices).  BUCTD's models are
small and activations dominate, so the mesh is pure data parallelism, as in
JAX: the global batch is ``BATCH_SIZE_PER_GPU x mesh.size`` and each device
takes its contiguous rows of it.

The functions keep JAX's names:

  * ``make_mesh`` reads ``TPU.MESH_SHAPE``/``MESH_AXES`` (-1 filled in) and
    raises where the shape's product is not the device count;
  * ``shard_batch`` splits this process's rows into one equal contiguous
    block a local device, each on its device; ``replicate`` broadcasts a
    module's parameters and buffers from process 0 and copies the module to
    the other local devices; ``host_local_rows`` brings a device batch back
    to the host in row order;
  * ``allgather_rows`` gathers variable-length row blocks of every process
    (pad to the common capacity, gather, trim by the gathered counts), and
    ``dcn_merge_rows`` is the evaluation's merge of (preds, boxes, db
    index).  The annotation ids in the boxes' column 6 gather as int64 and
    come back exact (CrowdPose's exceed 2^24), the other box columns as
    float64; JAX splits the ids into int32 halves and rides the rest as
    float32 because it runs without x64, which torch does not need.  Image
    paths are rebuilt by the caller from the gathered db indices, not
    gathered as strings.

Host arrays travel over ``parallel/distributed.py::host_group``: gloo,
also beside NCCL, which takes no CPU tensors.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..utils import distributed
from .distributed import host_group, process_device


@dataclasses.dataclass
class Mesh:
    devices: list            # the devices this process drives
    shape: tuple             # over the devices of every process
    axis_names: tuple

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def fill_mesh_shape(shape, n: int) -> tuple:
    """``TPU.MESH_SHAPE`` with its -1 filled in for ``n`` devices; a shape
    whose product is not ``n`` raises."""
    shape = [int(s) for s in shape]
    known = int(np.prod([s for s in shape if s > 0])) or 1
    filled = tuple(n // known if s == -1 else s for s in shape)
    if int(np.prod(filled)) != n:
        raise ValueError(f"TPU.MESH_SHAPE {shape} -> mesh {filled} does not match the "
                         f"{n} device(s) of this run ({distributed.process_info()[1]} "
                         f"process(es)): launch one process a card with "
                         f"--coordinator/--num-processes/--process-id or torchrun")
    return filled


def default_devices() -> list:
    """The process's card where ``initialize_distributed`` gave it one, else
    every local card, else the CPU."""
    dev = process_device()
    if dev is not None:
        return [dev]
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(cfg=None, devices=None) -> Mesh:
    """The run's mesh over ``devices`` (this process's; default
    ``default_devices()``) on every process: the cfg's ``TPU.MESH_SHAPE``
    and ``MESH_AXES``, or one 'data' axis over them all."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else default_devices())]
    if cfg is not None:
        shape, axes = list(cfg.TPU.MESH_SHAPE), tuple(cfg.TPU.MESH_AXES)
    else:
        shape, axes = [-1], ("data",)
    n = len(devices) * distributed.process_info()[1]
    return Mesh(devices, fill_mesh_shape(shape, n), axes)


def _blocks(x, k: int) -> list:
    if x.shape[0] % k:
        raise ValueError(f"{x.shape[0]} rows do not split over {k} devices")
    return list(torch.as_tensor(x).chunk(k)) if k > 1 else [torch.as_tensor(x)]


def shard_batch(batch, mesh: Mesh) -> list:
    """This process's rows of a batch (a tensor, an array or a dict of
    them) as one equal contiguous block a local device, each block on its
    device; a list in ``mesh.devices`` order."""
    k = len(mesh.devices)
    if isinstance(batch, dict):
        parts = {key: _blocks(v, k) for key, v in batch.items()}
        return [{key: parts[key][i].to(d) for key in batch}
                for i, d in enumerate(mesh.devices)]
    return [b.to(d) for b, d in zip(_blocks(batch, k), mesh.devices)]


def replicate(module: torch.nn.Module, mesh: Mesh) -> list:
    """``module`` on every device of the mesh: its parameters and buffers
    broadcast from process 0 (in place), then one copy a further local
    device.  Returns the replicas in ``mesh.devices`` order, ``module``
    first (moved to the first device)."""
    import torch.distributed as dist

    module.to(mesh.devices[0])
    if distributed.process_info()[1] > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return [module] + [copy.deepcopy(module).to(d) for d in mesh.devices[1:]]


def host_local_rows(x) -> np.ndarray:
    """A device batch (a tensor, or ``shard_batch``'s per-device blocks) on
    the host, its rows in order."""
    if isinstance(x, (list, tuple)):
        return np.concatenate([host_local_rows(b) for b in x], axis=0)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _gather(a: np.ndarray) -> np.ndarray:
    """(world, ...) : every process's ``a`` (one shape on all), in rank order."""
    import torch.distributed as dist

    if distributed.process_info()[1] == 1:
        return np.asarray(a)[None]
    t = torch.from_numpy(np.ascontiguousarray(a))
    out = [torch.empty_like(t) for _ in range(distributed.process_info()[1])]
    dist.all_gather(out, t, group=host_group())
    return np.stack([o.numpy() for o in out])


def allgather_rows(local: np.ndarray, count: int, capacity: int, counts=None) -> np.ndarray:
    """Every process's ``local[:count]``, concatenated in process order (the
    dataset's order for contiguous shards), on every process.  Each pads to
    the common ``capacity``, all gather, and each block is trimmed back to
    its count; ``counts``, the gathered counts, lets several calls share one
    gather of them.  A no-op single-process."""
    if distributed.process_info()[1] == 1:
        return local[:count]
    if counts is None:
        counts = _gather(np.asarray([count], np.int64))[:, 0]
    pad = np.zeros((capacity,) + local.shape[1:], local.dtype)
    pad[:count] = local[:count]
    gathered = _gather(pad)
    return np.concatenate([gathered[q, :int(counts[q])] for q in range(len(gathered))],
                          axis=0)


def dcn_merge_rows(all_preds: np.ndarray, all_boxes: np.ndarray, all_db_idx: np.ndarray,
                   count: int, capacity: int, id_col: int = 6):
    """Merge every process's evaluation rows: (preds, boxes, db indices,
    total) on every process, in process order.

    Each process holds ``[:count]`` valid rows of its ``capacity``.  One
    gather of the counts serves the four row gathers.  The boxes come back
    float64 in their column layout (the lambda sweep's column 7 passes
    through), the ids of ``id_col`` exact through an int64 gather; the db
    indices int64, from which the caller rebuilds the image paths."""
    counts = _gather(np.asarray([count], np.int64))[:, 0]

    def gather(a):
        return allgather_rows(a, count, capacity, counts=counts)

    ids = gather(all_boxes[:, id_col].astype(np.int64))
    boxes = gather(all_boxes.astype(np.float64))
    boxes[:, id_col] = ids
    return (gather(all_preds), boxes, gather(all_db_idx.astype(np.int64)),
            int(counts.sum()))
