"""buctd_tpu_torch/parallel/ and global-batch BatchNorm vs buctd_tpu, on the CPU.

* ``make_mesh``: the TPU.MESH_SHAPE/MESH_AXES it accepts give JAX's mesh
  shapes over as many devices, and the ones JAX's assert refuses raise;
* ``allgather_rows`` and ``dcn_merge_rows`` single-process against JAX's
  functions on the same rows: preds and db indices equal, annotation ids
  exact (2^31 + 5, 2^40 + 3 and 2^24 + 1 among them), the other box columns
  equal to the input (JAX's within float32 rounding of them: it rides them
  as float32 without x64);
* the same in two real processes over gloo (tests/torch_dist_children.py):
  blocks of 3 and 2 rows of a capacity of 4 merge into what JAX's merge
  gives single-process on the five rows; ``process_shard``, ``is_primary``,
  a second ``initialize_distributed``, ``shard_batch``, ``replicate``'s
  broadcast from process 0;
* models/hrnet.py::BatchNorm2d in training, two processes of 4 rows
  against flax's BatchNorm (buctd_tpu/models/hrnet.py::batch_norm) on the
  8-row global batch: the output, the input gradient of sum(y * dy), the
  weight and bias gradients (the processes' sums: DDP averages them), the
  running statistics, within 1e-5 + 1e-4 x |ref|, and within 1e-6 of the
  port's one-process module.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)

import numpy as np
import pytest
import torch

import torch_dist_children as tdc
from test_torch_port_config import load_cfg

ATOL, RTOL = 1e-5, 1e-4          # JAX's own tolerance for the sharded steps


@pytest.mark.parametrize("shape,devices", [
    ([-1], 1), ([1], 1), ([-1], 2), ([2], 2), ([1, -1], 2), ([-1, 2], 4), ([2, 2], 4)])
def test_make_mesh_takes_the_shapes_jax_takes(shape, devices):
    import jax

    from buctd_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from buctd_tpu_torch.parallel import make_mesh

    axes = ["data", "model"][:len(shape)]
    opts = ["TPU.MESH_SHAPE", str(shape), "TPU.MESH_AXES", str(axes)]
    mesh = make_mesh(load_cfg("torch", opts=opts), devices=["cpu"] * devices)
    want = jax_make_mesh(load_cfg("jax", opts=opts), devices=jax.devices()[:devices])
    assert mesh.shape == want.devices.shape and mesh.size == want.size == devices
    assert mesh.axis_names == tuple(want.axis_names)
    assert mesh.devices == [torch.device("cpu")] * devices


@pytest.mark.parametrize("shape,devices", [([2], 1), ([4], 2), ([3, -1], 2), ([2, 2], 2)])
def test_make_mesh_refuses_what_jax_refuses(shape, devices):
    import jax

    from buctd_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from buctd_tpu_torch.parallel import make_mesh
    from buctd_tpu_torch.train.state import check_train_options

    opts = ["TPU.MESH_SHAPE", str(shape)]
    with pytest.raises(AssertionError):
        jax_make_mesh(load_cfg("jax", opts=opts), devices=jax.devices()[:devices])
    with pytest.raises(ValueError, match="does not match"):
        make_mesh(load_cfg("torch", opts=opts), devices=["cpu"] * devices)
    if devices == 1:          # one process: the trainer's check is the same
        with pytest.raises(ValueError, match="MESH_SHAPE"):
            check_train_options(load_cfg("torch", opts=opts))


def _rows(seed=0, n=5, cols=8):
    rng = np.random.RandomState(seed)
    preds = rng.randn(n, 3, 3).astype(np.float32)
    boxes = rng.rand(n, cols) * 300
    boxes[:, 6] = [7, 2 ** 31 + 5, 2 ** 40 + 3, 16_777_217, 3][:n]
    db_index = rng.permutation(50)[:n]
    return preds, boxes, db_index


def _check_merge(got, want, preds, boxes, db_index):
    """``got`` (the port's merge) against JAX's ``want`` on the same rows,
    and against the rows themselves."""
    pg, bg, dg, n = got
    assert n == want[3] == len(preds)
    np.testing.assert_array_equal(pg, want[0])
    np.testing.assert_array_equal(pg, preds)
    np.testing.assert_array_equal(dg, want[2])
    np.testing.assert_array_equal(dg, db_index)
    assert bg.dtype == np.float64
    assert bg[:, 6].astype(np.int64).tolist() == want[1][:, 6].astype(np.int64).tolist() \
        == boxes[:, 6].astype(np.int64).tolist()
    np.testing.assert_array_equal(bg, boxes)
    rest = [c for c in range(boxes.shape[1]) if c != 6]
    np.testing.assert_allclose(bg[:, rest], want[1][:, rest], rtol=2.0 ** -23, atol=0)


def test_merge_single_process_matches_jax():
    from buctd_tpu.parallel.mesh import allgather_rows as jax_allgather
    from buctd_tpu.parallel.mesh import dcn_merge_rows as jax_merge
    from buctd_tpu_torch.parallel import allgather_rows
    from buctd_tpu_torch.parallel.mesh import dcn_merge_rows, host_local_rows

    preds, boxes, db_index = _rows()
    np.testing.assert_array_equal(allgather_rows(preds, 3, 5), jax_allgather(preds, 3, 5))
    for cols in (7, 8):                        # validate's boxes, the lambda sweep's
        p, b, d = _rows(cols=cols)
        _check_merge(dcn_merge_rows(p, b, d, 4, 5), jax_merge(p, b, d, 4, 5),
                     p[:4], b[:4], d[:4])
    assert np.array_equal(host_local_rows([torch.ones(2, 3), torch.zeros(1, 3)]),
                          np.concatenate([np.ones((2, 3)), np.zeros((1, 3))]))


def test_collectives_in_two_processes(tmp_path):
    from buctd_tpu.parallel.mesh import dcn_merge_rows as jax_merge

    preds, boxes, db_index = _rows()
    counts, capacity = [3, 2], 4
    blocks = []
    for lo, n in ((0, 3), (3, 2)):            # each padded to the capacity with garbage
        pad = capacity - n
        blocks.append({"preds": np.concatenate([preds[lo:lo + n],
                                                np.full((pad, 3, 3), 9.0, np.float32)]),
                       "boxes": np.concatenate([boxes[lo:lo + n], np.full((pad, 8), -1.0)]),
                       "db_index": np.concatenate([db_index[lo:lo + n], [99] * pad])})
    torch.save({"counts": counts, "capacity": capacity, "blocks": blocks},
               tmp_path / "collectives_job.pt")
    outs = tdc.spawn("collectives", tmp_path)
    want = jax_merge(preds, boxes, db_index, 5, 5)
    for rank, out in enumerate(outs):
        assert out["again"] is True and out["primary"] == (rank == 0)
        assert out["shard"] == (slice(0, 5) if rank == 0 else slice(5, 10))
        assert out["mesh"] == ((2,), 2)
        np.testing.assert_array_equal(out["rows"], preds)
        _check_merge(out["merge"], want, preds, boxes, db_index)
        # process 0's weights on every process; one device, one replica
        assert out["replicas"] == 1 and bool((out["weight"] == 1.0).all())
        torch.testing.assert_close(out["local"], torch.arange(4.0)[:, None] + 10 * rank)


def _bn_job():
    rng = np.random.RandomState(3)
    return {"x": (rng.randn(8, 5, 6, 7) * 2 + 0.5).astype(np.float32),
            "dy": rng.randn(8, 5, 6, 7).astype(np.float32),
            "weight": (rng.rand(5) + 0.5).astype(np.float32),
            "bias": rng.randn(5).astype(np.float32)}


def test_global_batchnorm_matches_flax_on_the_global_batch(tmp_path):
    import jax
    import jax.numpy as jnp

    from buctd_tpu.models.hrnet import batch_norm as jax_batch_norm

    job = _bn_job()
    torch.save(job, tmp_path / "bn_job.pt")
    outs = tdc.spawn("bn", tmp_path)
    one = tdc.bn_job(job)

    bn = jax_batch_norm()
    C = job["x"].shape[1]
    stats = {"mean": jnp.zeros(C), "var": jnp.ones(C)}
    dy = jnp.asarray(job["dy"].transpose(0, 2, 3, 1))

    def f(params, x):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, x,
                          use_running_average=False, mutable=["batch_stats"])
        return (y * dy).sum(), (y, upd["batch_stats"])

    params = {"scale": jnp.asarray(job["weight"]), "bias": jnp.asarray(job["bias"])}
    (_, (y, new)), (dparams, dx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(job["x"].transpose(0, 2, 3, 1)))
    want = {"y": np.asarray(y).transpose(0, 3, 1, 2), "dx": np.asarray(dx).transpose(0, 3, 1, 2),
            "dweight": np.asarray(dparams["scale"]), "dbias": np.asarray(dparams["bias"]),
            "running_mean": np.asarray(new["mean"]), "running_var": np.asarray(new["var"])}
    got = {"y": torch.cat([o["y"] for o in outs]), "dx": torch.cat([o["dx"] for o in outs]),
           "dweight": sum(o["dweight"] for o in outs), "dbias": sum(o["dbias"] for o in outs)}
    for o in outs:                  # the running statistics move alike on every process
        torch.testing.assert_close(o["running_mean"], outs[0]["running_mean"], rtol=0, atol=0)
        torch.testing.assert_close(o["running_var"], outs[0]["running_var"], rtol=0, atol=0)
    got.update(running_mean=outs[0]["running_mean"], running_var=outs[0]["running_var"])
    for key, ref in want.items():
        np.testing.assert_allclose(got[key].numpy(), ref, rtol=RTOL, atol=ATOL, err_msg=key)
        np.testing.assert_allclose(got[key].numpy(), one[key].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=key)
