"""buctd_tpu_torch's host cv2 Loader (TPU.DEVICE_PIPELINE False, the JAX
default) vs buctd_tpu's, on the CPU at tiny size.

* ``JointsDataset.get_sample``: the uint8 crops bit for bit (both packages
  run cv2.warpAffine on the same plan) and the metadata exactly, train (flips,
  rotations, crop-aug masks, half body, condition synthesis) and eval;
* the ``Loader``'s batches, train and eval: 'input' within the tolerances of
  tests/test_torch_port_loader.py::test_device_loader_matches_jax (RGB: 99%
  of an unrotated crop within 0.02, a rotated crop's mean error under 0.15;
  the condition channels 1e-3), the targets and weights within 1e-6, the
  metadata exactly;
* the sharding helpers with the process index and count patched to (p, k)
  in both packages, as JAX's tests patch theirs;
* ``DATASET.DATA_FORMAT zip``: ``zipreader.imread`` bit for bit JAX's, and a
  dataset read from a zip archive gives the same samples as from the files;
* ``valid.run`` with the host Loader against JAX's ``validate`` over its
  ``Loader`` (same weights): keypoints within 1e-3 px and AP within 1e-3,
  tests/test_torch_port_eval.py's tolerances;
* ``train.run`` for 2 steps on the host Loader with ``DEBUG.DEBUG``: the
  debug dumps and one ``train_loss`` line a step in ``metrics.jsonl``;
* the trainer validates through the host Loader whatever
  ``TPU.DEVICE_PIPELINE`` says (tools/train.py:126-128).
Both packages read the same CrowdPose-format set, seeded alike, one loader
thread each, so the host draws come in the same order.
"""

import json
import zipfile

import numpy as np
import pytest
import torch

from test_data_pipeline import _seed_all, _tiny_coco
from test_torch_port_config import COAM_YAML, TINY_COAM, jax_variables, load_cfg

TINY = ["MODEL.IMAGE_SIZE", "[96, 128]", "MODEL.HEATMAP_SIZE", "[24, 32]",
        "DATASET.ROT_FACTOR", "45"]
META = ("joints", "joints_vis", "cond_joints", "cond_joints_vis", "has_cond", "center",
        "scale", "rotation", "score", "annotation_id", "cond_max_iou")
J = 14


def _opts(tmp_path, train, *extra):
    ann_file, _ = _tiny_coco(tmp_path, J=J)
    key = "TRAIN" if train else "TEST"
    return TINY + [f"DATASET.{key}_IMAGE_DIR", str(tmp_path),
                   f"DATASET.{key}_ANNOTATION_FILE", ann_file,
                   "TEST.USE_GT_BBOX", "False", *extra]


def _datasets(opts, train):
    from buctd_tpu.data import get_dataset as jax_dataset
    from buctd_tpu_torch.data.datasets import get_dataset

    jcfg, cfg = load_cfg("jax", COAM_YAML, opts), load_cfg("torch", COAM_YAML, opts)
    return get_dataset(cfg, is_train=train), jax_dataset(jcfg, is_train=train), cfg, jcfg


def _same_meta(got, want, keys=META):
    for key in keys:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_get_sample_matches_jax_bit_for_bit(tmp_path, train):
    ours, theirs, _, _ = _datasets(_opts(tmp_path, train), train)
    _seed_all(3)
    jax_samples = [theirs.get_sample(i) for i in range(len(theirs.db))]
    _seed_all(3)
    samples = [ours[i] for i in range(len(ours.db))]
    assert len(samples) == 4
    for got, want in zip(samples, jax_samples):
        assert got["image"].dtype == np.uint8 and got["image"].shape == (128, 96, 3)
        np.testing.assert_array_equal(got["image"], want["image"])
        _same_meta(got, want)
        assert got["image_path"] == want["image_path"]
        assert sorted(got) == sorted(want)
    if train:
        assert any(abs(s["rotation"]) > 0 for s in samples)


def _loaders(tmp_path, train, *extra):
    from buctd_tpu.data import Loader as JaxLoader
    from buctd_tpu_torch.data.pipeline import Loader

    ours, theirs, cfg, jcfg = _datasets(_opts(tmp_path, train, *extra), train)
    return (Loader(ours, cfg, batch_size=3, num_workers=1, device="cpu"),
            JaxLoader(theirs, jcfg, batch_size=3, num_workers=1))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_loader_matches_jax(tmp_path, train):
    ours, theirs = _loaders(tmp_path, train)
    assert len(ours) == len(theirs) == 2
    _seed_all(7)
    jbatches = list(theirs)
    _seed_all(7)
    batches = list(ours)
    ours.close()
    for tb, jb in zip(batches, jbatches):
        _same_meta(tb, jb, META + ("db_index", "valid"))
        assert tb["image_path"] == jb["image_path"]
        got_in = tb["input"].permute(0, 2, 3, 1).numpy()        # NCHW here, NHWC in JAX
        want_in = np.asarray(jb["input"])
        assert got_in.shape == want_in.shape == (3, 128, 96, 6)
        for k, rot in enumerate(np.asarray(jb["rotation"])):
            err = np.abs(got_in[k, ..., :3] - want_in[k, ..., :3])
            if abs(rot) < 1e-6:
                assert np.mean(err < 0.02) > 0.99, (k, err.max())
            else:
                assert err.mean() < 0.15, (k, rot, err.mean())
        np.testing.assert_allclose(got_in[..., 3:], want_in[..., 3:], atol=1e-3)
        np.testing.assert_allclose(tb["target"].numpy(),
                                   np.asarray(jb["target"]).transpose(0, 3, 1, 2), atol=1e-6)
        np.testing.assert_allclose(tb["target_weight"].numpy(),
                                   np.asarray(jb["target_weight"]), atol=1e-6)
    # the last batch pads with its last sample: 4 samples, batch 3
    assert list(batches[1]["valid"]) == [1, 0, 0] and list(batches[1]["db_index"]) == [3, 3, 3]


@pytest.mark.parametrize("pk", [(0, 1), (0, 2), (1, 2), (2, 3), (4, 5)])
def test_sharding_helpers_match_jax(monkeypatch, pk):
    import buctd_tpu.data.pipeline as jp
    import buctd_tpu_torch.data.pipeline as tp
    from buctd_tpu_torch.utils import distributed

    monkeypatch.setattr(jp, "_process_info", lambda: pk)
    monkeypatch.setattr(distributed, "process_info", lambda: pk)
    order = np.random.RandomState(1).permutation(7)
    for n in (1, 4, 7, 12):
        assert tp.shard_length(n) == jp.shard_length(n)
    got, want = tp.shard_epoch_order(order), jp.shard_epoch_order(order)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    for b in (pk[1], 6 * pk[1]):
        assert tp.local_batch_size(b) == jp.local_batch_size(b)
    if pk[1] > 1:
        with pytest.raises(ValueError):
            tp.local_batch_size(pk[1] + 1)


def test_process_info_without_distributed():
    from buctd_tpu_torch.utils.distributed import process_info

    assert process_info() == (0, 1)


@pytest.mark.parametrize("rot", [0.0, 30.0], ids=["eval", "rotated"])
def test_chip_smoke_knows_the_installed_opencv_sampling(rot):
    """chip_smoke.py holds the host crops to numpy's bilinear at the exact
    source point (OpenCV 5) or at the point rounded to 1/32 px (OpenCV 4's
    fixed-point tables): the installed OpenCV's crop of a noise image is
    within one level of one of them, and a crop whose affine is off by 1/8
    px matches neither."""
    import cv2

    import chip_smoke

    img = np.random.RandomState(4).randint(0, 256, (96, 128, 3), np.uint8)
    c, s = 1.7 * np.cos(np.radians(rot)), 1.7 * np.sin(np.radians(rot))
    trans = np.array([[c, s, -61.3], [-s, c, -47.9]])      # source -> crop, 1.7x
    crop = cv2.warpAffine(img, trans, (48, 64), flags=cv2.INTER_LINEAR)
    got = chip_smoke.cv2_sampling(np, [crop], [img], [trans], (48, 64))
    assert got["match"] is not None, got
    off = trans.copy()
    off[0, 2] += 0.125
    assert chip_smoke.cv2_sampling(np, [crop], [img], [off], (48, 64))["match"] is None


def _zip_of(tmp_path, names):
    path = tmp_path / "images.zip"
    with zipfile.ZipFile(path, "w") as zf:
        for name in names:
            zf.write(tmp_path / name, arcname=name)
    return path


def test_zip_reads_match_jax(tmp_path):
    import cv2

    from buctd_tpu.utils import zipreader as jzr
    from buctd_tpu_torch.data.joints_dataset import imread_rgb
    from buctd_tpu_torch.utils import zipreader

    _tiny_coco(tmp_path, J=J)
    path = _zip_of(tmp_path, ["im0.png", "im1.png"])
    for name in ("im0.png", "im1.png"):
        member = f"{path}@/{name}"
        assert zipreader.split_zip_path(member) == jzr.split_zip_path(member)
        got = zipreader.imread(member, cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(got, jzr.imread(member, cv2.IMREAD_COLOR))
        np.testing.assert_array_equal(imread_rgb(member, True, "zip"),
                                      imread_rgb(str(tmp_path / name), True, "jpg"))
    with pytest.raises(FileNotFoundError):
        zipreader.imread(f"{tmp_path / 'none.zip'}@/im0.png")

    # a dataset read through the archive gives the files' samples
    opts = _opts(tmp_path, False)
    files, _, _, _ = _datasets(opts, False)
    zipped, _, _, _ = _datasets(opts + ["DATASET.TEST_IMAGE_DIR", f"{path}@",
                                        "DATASET.DATA_FORMAT", "zip"], False)
    for i in range(len(files.db)):
        a, b = files.get_sample(i), zipped.get_sample(i)
        np.testing.assert_array_equal(a["image"], b["image"])
        _same_meta(a, b)


def _weights(tmp_path, jcfg):
    """JAX variables of the tiny CoAM and the same weights as a .pth."""
    from buctd_tpu_torch.convert import from_flax

    jmodel, variables = jax_variables(jcfg, seed=6)
    path = tmp_path / "tiny.pth"
    torch.save(from_flax(variables), path)
    return jmodel, variables, path


def test_valid_run_host_loader_matches_jax(tmp_path):
    """valid.run with TPU.DEVICE_PIPELINE False vs JAX's validate over its
    host Loader, the same weights and eval set."""
    from buctd_tpu.core.function import validate as jax_validate
    from buctd_tpu.data import Loader as JaxLoader
    from buctd_tpu.data import get_dataset as jax_dataset
    from buctd_tpu_torch.valid import run

    ann_file, _ = _tiny_coco(tmp_path, n_imgs=2, people=2, J=J)
    opts = TINY_COAM + ["DATASET.TEST_IMAGE_DIR", str(tmp_path),
                        "DATASET.TEST_ANNOTATION_FILE", ann_file,
                        "TEST.BATCH_SIZE_PER_GPU", "3", "WORKERS", "1", "PRINT_FREQ", "1"]
    cfg, jcfg = load_cfg("torch", opts=opts), load_cfg("jax", opts=opts)
    assert not cfg.TPU.DEVICE_PIPELINE
    jmodel, variables, weights = _weights(tmp_path, jcfg)
    res = run.main(["--cfg", str(COAM_YAML), "--device", "cpu", *opts,
                    "TEST.MODEL_FILE", str(weights), "OUTPUT_DIR", str(tmp_path / "ours"),
                    "LOG_DIR", str(tmp_path / "log")])
    jds = jax_dataset(jcfg, is_train=False)
    _, jap = jax_validate(jcfg, JaxLoader(jds, jcfg, batch_size=3, num_workers=1), jds,
                          jmodel, variables, str(tmp_path / "jax"), epoch=0)
    name = "results/keypoints_test_results_epoch0.json"
    got = json.loads((res["output_dir"] / name).read_text())
    want = json.loads((tmp_path / "jax" / name).read_text())
    assert len(got) == len(want) == 4 == res["rounds"][0]["crops"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.reshape(g["keypoints"], (J, 3))[:, :2],
                                   np.reshape(w["keypoints"], (J, 3))[:, :2], atol=1e-3)
        assert g["annotation_id"] == w["annotation_id"]
    assert 0.0 <= res["ap"][0] <= 1.0 and abs(res["ap"][0] - jap) <= 1e-3
    rows = [json.loads(line) for line in (res["log_dir"] / "metrics.jsonl").read_text()
            .splitlines()]
    assert {"valid_loss", "valid_acc", "valid_AP"} <= {r["tag"] for r in rows}
    assert res["summary"]["params"] > 0 and res["summary"]["flash_calls"] == 0


def _train_opts(tmp_path, *extra):
    ann_file, _ = _tiny_coco(tmp_path, n_imgs=2, people=2, J=J)
    return ["--cfg", str(COAM_YAML), "--device", "cpu", *TINY_COAM,
            "DATASET.TRAIN_IMAGE_DIR", str(tmp_path), "DATASET.TRAIN_ANNOTATION_FILE", ann_file,
            "TRAIN.BATCH_SIZE_PER_GPU", "2", "WORKERS", "1", "PRINT_FREQ", "1",
            "OUTPUT_DIR", str(tmp_path / "out"), "LOG_DIR", str(tmp_path / "log"), *extra]


def test_train_entry_host_loader_writes_debug_dumps_and_metrics(tmp_path):
    from buctd_tpu_torch.train import run

    debug = ["DEBUG.DEBUG", "True", "DEBUG.SAVE_BATCH_IMAGES_GT", "True",
             "DEBUG.SAVE_BATCH_IMAGES_PRED", "True", "DEBUG.SAVE_HEATMAPS_GT", "True",
             "DEBUG.SAVE_HEATMAPS_PRED", "True"]
    args = _train_opts(tmp_path, *debug)
    res = run.main(args[:2] + ["--steps", "2", "--no-eval"] + args[2:])
    assert res["steps"] == 2
    # the step's heatmaps go to the dumps and are not kept for the epoch
    assert all("out" not in m for st in res["stats"] for m in st["metrics"])
    out = res["output_dir"]
    for i in range(2):
        for kind in ("gt", "pred", "hm_gt", "hm_pred"):
            assert (out / f"train_epoch_0_iter_{i}_{kind}.jpg").stat().st_size > 0, (i, kind)
    rows = [json.loads(line) for line in (res["log_dir"] / "metrics.jsonl").read_text()
            .splitlines()]
    loss = [r for r in rows if r["tag"] == "train_loss"]
    assert [r["step"] for r in loss] == [0, 1] and all(np.isfinite(r["value"]) for r in loss)
    assert list(out.glob("coam_w48_384x288_*_train.log"))


def test_trainer_validates_through_the_host_loader(tmp_path, monkeypatch):
    """With TPU.DEVICE_PIPELINE True the trainer trains on the device loader
    and validates on the host Loader, as tools/train.py:126-128."""
    import buctd_tpu_torch.data.device_pipeline as dp
    import buctd_tpu_torch.data.pipeline as pl
    from buctd_tpu_torch.train import run

    built = []

    class HostSpy(pl.Loader):
        def __init__(self, dataset, *a, **k):
            built.append(("Loader", dataset.is_train))
            super().__init__(dataset, *a, **k)

    class DeviceSpy(dp.DeviceLoader):
        def __init__(self, dataset, *a, **k):
            built.append(("DeviceLoader", dataset.is_train))
            super().__init__(dataset, *a, **k)

    monkeypatch.setattr(pl, "Loader", HostSpy)
    monkeypatch.setattr(dp, "DeviceLoader", DeviceSpy)
    args = _train_opts(tmp_path, "TPU.DEVICE_PIPELINE", "True", "EPOCH_EVAL_FREQ", "1",
                       "DATASET.TEST_IMAGE_DIR", str(tmp_path),
                       "DATASET.TEST_ANNOTATION_FILE", str(tmp_path / "ann.json"),
                       "TEST.BATCH_SIZE_PER_GPU", "2")
    res = run.main(args[:2] + ["--steps", "3"] + args[2:])
    assert len(res["perf"]) == 1                 # epoch 0's validation: 2 steps an epoch
    assert built == [("DeviceLoader", True), ("Loader", False)]
