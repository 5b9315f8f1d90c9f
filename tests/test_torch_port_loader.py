"""buctd_tpu_torch device loader (host planning + K4 warp + renders + targets)
vs buctd_tpu's DeviceLoader, on the CPU.

Both read the same 14-joint CrowdPose-format set (test_data_pipeline's
``_tiny_coco``), seeded alike, one loader thread each, so the host draws
(augmentation, synthesis) come in the same order.  On the CPU the port's warp
is K4's plain version and the JAX loader's is the banded-matmul engine; both
are the two-pass warp.  Tolerances are those of
tests/test_device_pipeline.py:48-72 (its device-vs-host comparison).
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import numpy as np
import pytest
import torch

from test_data_pipeline import _seed_all, _tiny_coco
from test_torch_port_config import COAM_YAML, load_cfg

TINY_LOADER = ["MODEL.IMAGE_SIZE", "[96, 128]", "MODEL.HEATMAP_SIZE", "[24, 32]",
               "TPU.DEVICE_PIPELINE", "True", "DATASET.ROT_FACTOR", "45"]


def _loaders(tmp_path, train):
    ann_file, _ = _tiny_coco(tmp_path, J=14)
    key = "TRAIN" if train else "TEST"
    opts = TINY_LOADER + [f"DATASET.{key}_IMAGE_DIR", str(tmp_path),
                          f"DATASET.{key}_ANNOTATION_FILE", ann_file,
                          "TEST.USE_GT_BBOX", "False"]
    from buctd_tpu.data import get_dataset as jax_dataset
    from buctd_tpu.data.device_pipeline import DeviceLoader as JaxLoader
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.device_pipeline import DeviceLoader

    jcfg, cfg = load_cfg("jax", COAM_YAML, opts), load_cfg("torch", COAM_YAML, opts)
    ours = DeviceLoader(get_dataset(cfg, is_train=train), cfg, batch_size=4,
                        num_workers=1, device="cpu")
    theirs = JaxLoader(jax_dataset(jcfg, is_train=train), jcfg, batch_size=4,
                       num_workers=1)
    return ours, theirs


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_device_loader_matches_jax(tmp_path, train):
    ours, theirs = _loaders(tmp_path, train)
    assert len(ours.ds.db) == len(theirs.ds.db) == 4
    _seed_all(7)
    jb = next(iter(theirs))
    _seed_all(7)
    tb = next(iter(ours))
    ours.close()

    for key, atol in (("joints", 1e-3), ("cond_joints", 1e-3), ("center", 1e-4),
                      ("scale", 1e-5), ("rotation", 1e-6), ("trans_inv", 1e-4),
                      ("mask_box", 0)):
        np.testing.assert_allclose(tb[key], np.asarray(jb[key]), atol=atol, err_msg=key)
    if train:
        assert np.abs(tb["rotation"]).max() > 0      # the rotated warp really ran
    # NCHW here, NHWC in JAX
    got_in = tb["input"].permute(0, 2, 3, 1).numpy()
    want_in = np.asarray(jb["input"])
    assert got_in.shape == want_in.shape == (4, 128, 96, 6)
    rot = np.asarray(jb["rotation"])
    for k in range(4):
        err = np.abs(got_in[k, ..., :3] - want_in[k, ..., :3])
        if abs(rot[k]) < 1e-6:
            assert np.mean(err < 0.02) > 0.99, (k, err.max())
        else:
            assert err.mean() < 0.15, (k, rot[k], err.mean())
    np.testing.assert_allclose(got_in[..., 3:], want_in[..., 3:], atol=1e-3)
    np.testing.assert_allclose(tb["target"].numpy(),
                               np.asarray(jb["target"]).transpose(0, 3, 1, 2), atol=1e-4)
    np.testing.assert_allclose(tb["target_weight"].numpy(),
                               np.asarray(jb["target_weight"]), atol=1e-6)


def test_generate_target_matches_jax():
    import jax.numpy as jnp

    from buctd_tpu.ops import generate_target as jax_target
    from buctd_tpu_torch.ops.heatmap import generate_target

    rng = np.random.RandomState(3)
    joints = rng.uniform(-40, 330, (3, 14, 2)).astype(np.float32)
    vis = (rng.rand(3, 14) > 0.2).astype(np.float32)
    tgt, w = generate_target(torch.from_numpy(joints), torch.from_numpy(vis),
                             (288, 384), (72, 96), 3)
    jt, jw = jax_target(jnp.asarray(joints), jnp.asarray(vis), (288, 384), (72, 96), 3)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jt), atol=1e-6)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_host_planning_refuses_unported_paths(tmp_path):
    from buctd_tpu_torch.core.function import check_eval_options
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.train.state import check_train_options

    ann_file, _ = _tiny_coco(tmp_path, J=14)
    cfg = load_cfg("torch", COAM_YAML, TINY_LOADER + [
        "DATASET.TEST_IMAGE_DIR", str(tmp_path), "DATASET.TEST_ANNOTATION_FILE", ann_file,
        "TEST.LAMBDA_SWEEP", "True", "DEBUG.DEBUG", "True"])
    assert len(get_dataset(cfg, is_train=False).db) == 4
    check_eval_options(cfg)                 # the lambda sweep and eval debug dumps: ported
    check_train_options(cfg)                # the train debug dumps: ported
    for bad in (check_eval_options, check_train_options):
        with pytest.raises(ValueError, match="MESH_SHAPE.*does not match"):
            bad(load_cfg("torch", COAM_YAML, ["TPU.MESH_SHAPE", "[2]"]))
    coco_ann, _ = _tiny_coco(tmp_path, J=17)
    ochuman = load_cfg("torch", COAM_YAML, ["DATASET.DATASET", "ochuman", "MODEL.NUM_JOINTS",
                                            "17", "DATASET.TRAIN_IMAGE_DIR", str(tmp_path),
                                            "DATASET.TRAIN_ANNOTATION_FILE", coco_ann])
    ds = get_dataset(ochuman, is_train=True)
    assert type(ds).__name__ == "OCHumanDataset" and len(ds.db) == 4
