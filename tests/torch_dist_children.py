"""The processes of the port's multi-process CPU tests, and the jobs they run.

A test writes a job (``torch.save`` of a dict) into its temp directory and
starts ``spawn(scenario, tmp)``: N real processes of this file, each
joining a gloo group on a free localhost port
(parallel/distributed.py::initialize_distributed, ``device="cpu"``), running
the scenario's job on its rows, and saving what it saw as
``<scenario>_out<rank>.pt``.  Each process has its own ``communicate``
timeout, so no test can hang the run.  The same job functions run in the
test's own process with ``world=1`` for the one-process reference.  This
module imports no JAX: the JAX side is computed by the test.

    python tests/torch_dist_children.py <scenario> <rank> <world> <port> <tmp>
"""

import socket
import subprocess
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
TIMEOUT = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(scenario: str, tmp, world: int = 2, timeout: int = TIMEOUT) -> list:
    """Run ``scenario`` in ``world`` processes; returns each process's saved
    output (rank order).  A process that fails or outlives ``timeout``
    fails the test with every process's output."""
    import torch

    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__)), scenario, str(r),
                               str(world), str(port), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=str(REPO))
             for r in range(world)]
    return _collect(procs, timeout, [Path(tmp) / f"{scenario}_out{r}.pt"
                                     for r in range(world)], torch)


def spawn_command(argv_of_rank, world: int = 2, timeout: int = TIMEOUT) -> list:
    """Run ``argv_of_rank(rank, port)`` (a python -m command line) in
    ``world`` processes from the repository root; returns their outputs."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, *argv_of_rank(r, port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=str(REPO))
             for r in range(world)]
    return _collect(procs, timeout, None, None)


def _collect(procs, timeout, files, torch) -> list:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} failed:\n{out}\n" + "\n".join(
            f"--- process {q}:\n{o}" for q, o in enumerate(outs) if q != r)
    if files is None:
        return outs
    return [torch.load(f, weights_only=False) for f in files]


# ------------------------------------------------------------------ jobs ----

def rows(x, rank: int, world: int):
    """This process's contiguous rows of a global batch."""
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def load_cfg(yaml, opts):
    import types

    from buctd_tpu_torch.config import default_config, update_config

    cfg = default_config()
    update_config(cfg, types.SimpleNamespace(cfg=str(yaml), opts=list(opts)))
    return cfg


def port_model(cfg, state_dict):
    """The cfg's model on the CPU with ``state_dict``, its dropout at 0 (the
    nn.Dropout modules and TransPose-H's attention dropout, a float)."""
    import torch

    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.models.transpose import MultiheadSelfAttention

    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        elif isinstance(m, MultiheadSelfAttention):
            m.dropout = 0.0
    return model


def train_job(job: dict, rank: int = 0, world: int = 1) -> dict:
    """``job['steps']`` calls of the trainer's step (train/state.py::
    make_train_step: plain, TRAIN.MIX, GRAD_ACCUM_STEPS, REMAT,
    FUSED_OPTIMIZER as the cfg says) on this process's rows of each global
    batch of ``job['batches']``.  Returns the global loss, acc and cnt of
    each call and the model's state dict after them."""
    import torch

    from buctd_tpu_torch.train.state import make_lr_schedule, make_optimizer, make_train_step

    cfg = load_cfg(job["yaml"], job["opts"])
    model = port_model(cfg, job["state_dict"])
    dtype = job.get("dtype", torch.float32)
    model.to(dtype)
    optimizer = make_optimizer(cfg, model)
    step = make_train_step(cfg, model, optimizer, make_lr_schedule(cfg, optimizer, 10),
                           torch.Generator().manual_seed(0), seed=3)
    out = {"loss": [], "acc": [], "cnt": []}
    for batch in job["batches"]:
        local = {k: rows(torch.as_tensor(v).to(dtype), rank, world) for k, v in batch.items()}
        m = step(local)
        for k in out:
            out[k].append(float(m[k]))
    out["state_dict"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return out


def mixed_batch_job(job: dict, rank: int = 0, world: int = 1) -> dict:
    """The double-target batch the mixed step builds from this process's rows
    of ``job['batch']`` (train/mixing.py, the draws of call 0)."""
    import torch

    from buctd_tpu_torch.train.mixing import make_mix_fn
    from buctd_tpu_torch.train.state import MixedTrainStep

    cfg = load_cfg(job["yaml"], job["opts"])
    local = {k: rows(torch.as_tensor(v), rank, world) for k, v in job["batch"].items()}
    step = MixedTrainStep.__new__(MixedTrainStep)          # the draws alone, no model
    step.draw_fn, step.mix_fn = make_mix_fn(cfg)
    step.seed, step.calls = 3, 0
    return step.mix_fn(local, step.draw(local))


def bn_job(job: dict, rank: int = 0, world: int = 1) -> dict:
    """models/hrnet.py::BatchNorm2d in training on this process's rows of
    ``job['x']``: y, the input gradient of sum(y * dy), this process's
    weight and bias gradients, and the running statistics after."""
    import torch

    from buctd_tpu_torch.models.hrnet import batch_norm

    x = rows(torch.as_tensor(job["x"]), rank, world).clone().requires_grad_(True)
    dy = rows(torch.as_tensor(job["dy"]), rank, world)
    bn = batch_norm(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(job["weight"]))
        bn.bias.copy_(torch.as_tensor(job["bias"]))
    y = bn(x)
    (y * dy).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def validate_job(job: dict, rank: int = 0, world: int = 1) -> dict:
    """``validate`` (job['kind'] 'validate'), ``validate_lambda_quantitative``
    ('lambda') or ``validate_lambda`` ('qualitative') of core/function.py
    on the host Loader at global batch ``job['batch']``, with
    ``dataset.evaluate`` recording what it is given (and then running)."""
    import numpy as np

    from buctd_tpu_torch.core import function
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.pipeline import Loader

    cfg = load_cfg(job["yaml"], job["opts"])
    model = port_model(cfg, job["state_dict"]).eval()
    ds = get_dataset(cfg, is_train=False)
    seen = {}
    evaluate = ds.evaluate

    def spy(cfg, preds, output_dir, all_boxes, img_path, epoch=-1):
        seen.update(preds=np.array(preds), boxes=np.array(all_boxes), paths=list(img_path),
                    output_dir=str(output_dir))
        return evaluate(cfg, preds, output_dir, all_boxes, img_path, epoch)

    ds.evaluate = spy
    loader = Loader(ds, cfg, batch_size=job["batch"], num_workers=1, device="cpu")
    out_dir = Path(job["out"])
    try:
        if job["kind"] == "validate":
            stats = {}
            _, ap = function.validate(cfg, loader, ds, model, out_dir, stats=stats)
            seen.update(ap=ap, loss=stats["loss"], acc=stats["acc"])
        elif job["kind"] == "lambda":
            stats = {}
            seen["ap"] = function.validate_lambda_quantitative(cfg, loader, ds, model,
                                                               out_dir, stats=stats)
            seen.update(loss=stats["loss"], acc=stats["acc"])
        else:
            seen["sweep"] = function.validate_lambda(cfg, loader, ds, model)
    finally:
        loader.close()
    return seen


def collectives_job(job: dict, rank: int = 0, world: int = 1) -> dict:
    """parallel/: the process flags' state, process_shard, allgather_rows
    and dcn_merge_rows on blocks of different lengths, shard_batch,
    replicate and the barrier."""
    import numpy as np
    import torch

    from buctd_tpu_torch.parallel import (allgather_rows, initialize_distributed,
                                          is_primary, make_mesh, process_shard, replicate,
                                          shard_batch)
    from buctd_tpu_torch.parallel.distributed import barrier
    from buctd_tpu_torch.parallel.mesh import dcn_merge_rows

    count = job["counts"][rank]
    blocks = job["blocks"][rank]
    mesh = make_mesh(devices=["cpu"])
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(float(rank + 1))
    replicas = replicate(module, mesh)
    local = shard_batch({"x": torch.arange(4.0)[:, None] + 10 * rank}, mesh)
    barrier()
    return {"again": initialize_distributed(), "primary": is_primary(),
            "shard": process_shard(10), "mesh": (mesh.shape, mesh.size),
            "rows": allgather_rows(blocks["preds"], count, job["capacity"]),
            "merge": dcn_merge_rows(blocks["preds"], blocks["boxes"], blocks["db_index"],
                                    count, job["capacity"]),
            "weight": replicas[0].weight.detach().clone(), "replicas": len(replicas),
            "local": local[0]["x"], "ids_dtype": str(np.asarray(blocks["boxes"]).dtype)}


JOBS = {"train": train_job, "mixed": mixed_batch_job, "bn": bn_job,
        "validate": validate_job, "collectives": collectives_job}


def main(argv) -> int:
    scenario, rank, world, port, tmp = argv[1], int(argv[2]), int(argv[3]), argv[4], argv[5]
    sys.path[:0] = [str(REPO), str(TESTS)]
    import torch_cpu_threads  # noqa: F401  (one torch thread a process)
    import torch
    import torch.distributed as dist

    from buctd_tpu_torch.parallel import initialize_distributed

    assert initialize_distributed(f"localhost:{port}", world, rank, device="cpu") is True
    assert (dist.get_rank(), dist.get_world_size(), dist.get_backend()) == (rank, world, "gloo")
    job = torch.load(Path(tmp) / f"{scenario}_job.pt", weights_only=False)
    out = JOBS[scenario](job, rank, world)
    torch.save(out, Path(tmp) / f"{scenario}_out{rank}.pt")
    dist.destroy_process_group()
    print(f"process {rank}: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
