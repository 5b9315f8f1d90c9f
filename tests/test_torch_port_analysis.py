"""buctd_tpu_torch's analysis, host NMS and debug images vs buctd_tpu's, on
the CPU.

* analysis/evaluation.py (``coco_evaluation``, ``bin_evaluate``,
  ``sort_instance_ap``) and analysis/qualitative_evaluation.py
  (``match_gt_to_dt``, ``binwise_coco_evaluation``) on a tiny COCO-17 GT with
  overlapping people and partly labelled poses, and detections with and
  without ``annotation_id``: every binned matrix, ranking and match equal;
  the qualitative dumps equal pixel for pixel (both draw with cv2).
* ops/native.py (``cpu_nms``, ``gpu_nms``) on random boxes with tied scores:
  the kept indices equal to the JAX package's ops/native.py (the same C++
  source, built apart); a compiler that fails raises with its message.
* utils/vis.py, utils/vis_coco.py and utils/skeletons.py, fed the port's
  NCHW tensors, draw the images JAX's functions draw from the NHWC arrays,
  pixel for pixel; ``validate`` with ``DEBUG.DEBUG`` writes the four debug
  images of each logged batch, the images JAX's ``save_debug_images`` makes
  of the same batch and heatmaps.
"""

import json

import cv2
import numpy as np
import pytest
import torch

J = 17


def _gt_dt(tmp_path, seed=0, n_img=4):
    """A COCO-17 GT json (people overlapping in pairs, 3 to 17 labelled
    joints, random images) and a detections json: one per person, its joints
    jittered, half with the ``annotation_id`` the evaluate jsons carry."""
    rng = np.random.RandomState(seed)
    images, anns, dts = [], [], []
    for i in range(n_img):
        name = f"im{i}.png"
        cv2.imwrite(str(tmp_path / name), rng.randint(0, 256, (240, 320, 3), np.uint8))
        images.append({"id": i + 1, "file_name": name, "width": 320, "height": 240})
        for p in range(1 + i % 4):
            x0, y0 = 15 + 55 * p + rng.uniform(-5, 5), rng.uniform(10, 50)
            xy = np.stack([rng.uniform(x0, x0 + 100, J), rng.uniform(y0, y0 + 170, J)], 1)
            n = int(rng.randint(3, J + 1))
            vis = np.zeros(J)
            vis[rng.permutation(J)[:n]] = 2
            xy[vis == 0] = 0
            kps = np.concatenate([xy, vis[:, None]], 1).ravel().tolist()
            anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": 1,
                         "iscrowd": 0, "keypoints": kps, "num_keypoints": n,
                         "bbox": [float(x0), float(y0), 100.0, 170.0], "area": 17000.0})
            d = np.concatenate([xy + rng.randn(J, 2) * rng.uniform(1, 15),
                                rng.uniform(0.1, 1, (J, 1))], 1)
            det = {"image_id": i + 1, "category_id": 1, "keypoints": d.ravel().tolist(),
                   "score": float(rng.uniform(0.2, 1))}
            if i % 2 == 0:
                det["annotation_id"] = anns[-1]["id"]
            dts.append(det)
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": 1, "name": "person", "keypoints": ["k"] * J,
                          "skeleton": []}]}
    gt_file, dt_file = tmp_path / "gt.json", tmp_path / "dt.json"
    gt_file.write_text(json.dumps(gt))
    dt_file.write_text(json.dumps(dts))
    return str(gt_file), str(dt_file)


def test_coco_evaluation_matches_jax(tmp_path):
    from buctd_tpu.analysis import coco_evaluation as jax_coco_evaluation
    from buctd_tpu_torch.analysis import coco_evaluation

    gt_file, dt_file = _gt_dt(tmp_path)
    got = coco_evaluation(gt_file, dt_file, output_dir=str(tmp_path), make_plots=True)
    want = jax_coco_evaluation(gt_file, dt_file)
    assert list(got) == list(want)
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["num_instances"].sum() == 10 and (got["num_instances"] > 0).sum() >= 4
    assert (tmp_path / "benchmark_AP.pdf").stat().st_size > 0    # matplotlib, lazily


def test_bin_evaluate_rank_and_match_match_jax(tmp_path):
    from buctd_tpu.analysis import bin_evaluate as jax_bin_evaluate
    from buctd_tpu.analysis import sort_instance_ap as jax_sort
    from buctd_tpu.analysis.qualitative_evaluation import match_gt_to_dt as jax_match
    from buctd_tpu.data.coco_io import COCOIndex as JIndex
    from buctd_tpu_torch.analysis import bin_evaluate, sort_instance_ap
    from buctd_tpu_torch.analysis.qualitative_evaluation import match_gt_to_dt
    from buctd_tpu_torch.data.coco_io import COCOIndex

    gt_file, dt_file = _gt_dt(tmp_path, seed=1)
    for og, ng in (([0], [11, 12, 13, 14, 15]), ([1, 2], [16, 17]), ([0, 1, 2], range(18))):
        got = bin_evaluate(COCOIndex(gt_file), dt_file, og, list(ng))
        assert got == jax_bin_evaluate(JIndex(gt_file), dt_file, og, list(ng))
    got = sort_instance_ap(COCOIndex(gt_file), dt_file)
    want = jax_sort(JIndex(gt_file), dt_file)
    assert [(o, a) for o, a, _ in got] == [(o, a) for o, a, _ in want] and len(got) == 4
    dts = json.loads(open(dt_file).read())
    got, want = match_gt_to_dt(COCOIndex(gt_file), dts), jax_match(JIndex(gt_file), dts)
    assert got == want and sum(v is not None for v in got.values()) > 0


def test_qualitative_dumps_match_jax_pixel_for_pixel(tmp_path):
    from buctd_tpu.analysis.qualitative_evaluation import (
        binwise_coco_evaluation as jax_binwise)
    from buctd_tpu_torch.analysis.qualitative_evaluation import binwise_coco_evaluation

    gt_file, dt_file = _gt_dt(tmp_path, seed=2)
    binwise_coco_evaluation(gt_file, dt_file, str(tmp_path), str(tmp_path / "ours"))
    jax_binwise(gt_file, dt_file, str(tmp_path), str(tmp_path / "jax"))
    got = sorted(p.relative_to(tmp_path / "ours") for p in (tmp_path / "ours").rglob("*.jpg"))
    want = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.jpg"))
    assert got == want and len(got) == 10
    for rel in got:
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "ours" / rel)),
                                      cv2.imread(str(tmp_path / "jax" / rel)), err_msg=str(rel))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_nms_matches_jax(seed):
    from buctd_tpu.ops import native as jax_native
    from buctd_tpu_torch.ops import native
    from buctd_tpu_torch.ops.nms import nms

    assert jax_native.native_available()          # JAX's C++ library, not its fallback
    rng = np.random.RandomState(seed)
    n = 700
    xy = rng.uniform(0, 600, (n, 2))
    dets = np.c_[xy, xy + rng.uniform(8, 120, (n, 2)),
                 np.round(rng.uniform(0, 1, n), 1)].astype(np.float32)   # tied scores
    for thresh in (0.3, 0.5, 0.7):
        got_cpu, got_gpu = native.cpu_nms(dets, thresh), native.gpu_nms(dets, thresh)
        assert got_cpu == jax_native.cpu_nms(dets, thresh)
        assert got_gpu == jax_native.gpu_nms(dets, thresh)
        assert sorted(got_gpu) == sorted(nms(dets, thresh))   # numpy: the same greedy
        assert 0 < len(got_cpu) < n
    assert native.cpu_nms(np.zeros((0, 5), np.float32), 0.5) == []
    assert native.gpu_nms(np.zeros((0, 5), np.float32), 0.5) == []


def test_native_build_failure_raises(monkeypatch, tmp_path):
    from buctd_tpu_torch import _build
    from buctd_tpu_torch.ops import native

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed on csrc/host_nms.cpp"):
        native.cpu_nms(np.ones((3, 5), np.float32), 0.5)
    assert not list(tmp_path.glob("*.so"))


def _vis_batch(seed=0, B=3, H=64, W=48, h=16, w=12):
    rng = np.random.RandomState(seed)
    images = rng.randn(B, H, W, 6).astype(np.float32)
    heatmaps = rng.rand(B, h, w, J).astype(np.float32)
    joints = np.concatenate([rng.uniform(0, [W, H], (B, J, 2)), np.zeros((B, J, 1))], -1)
    vis = np.repeat((rng.rand(B, J, 1) > 0.3).astype(np.float32), 3, -1)
    meta = {"joints": joints, "joints_vis": vis, "cond_joints": joints + 2.0,
            "cond_max_iou": np.array([0.0, 0.2, 0.7]),
            "image": [f"a/b/img{k}.jpg" for k in range(B)]}
    preds = rng.uniform(0, [W, H], (B, J, 2)).astype(np.float32)
    return images, heatmaps, meta, preds


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _same_images(ours, theirs):
    got = sorted(p.relative_to(ours) for p in ours.rglob("*.jpg"))
    assert got == sorted(p.relative_to(theirs) for p in theirs.rglob("*.jpg")) and got
    for rel in got:
        np.testing.assert_array_equal(cv2.imread(str(ours / rel)),
                                      cv2.imread(str(theirs / rel)), err_msg=str(rel))
    return got


def test_vis_functions_draw_jax_pixels(tmp_path):
    from buctd_tpu.utils import skeletons as jsk
    from buctd_tpu.utils import vis as jvis
    from buctd_tpu.utils import vis_coco as jvc
    from buctd_tpu_torch.utils import skeletons, vis, vis_coco

    from test_torch_port_config import load_cfg

    images, heatmaps, meta, preds = _vis_batch()
    tmeta = {**meta, "joints": torch.from_numpy(meta["joints"])}
    opts = ["DEBUG.DEBUG", "True", "DEBUG.SAVE_BATCH_IMAGES_GT", "True",
            "DEBUG.SAVE_BATCH_IMAGES_PRED", "True", "DEBUG.SAVE_HEATMAPS_GT", "True",
            "DEBUG.SAVE_HEATMAPS_PRED", "True", "DEBUG.SAVE_IOU_BIN_PRED", "True"]
    for root, mod, cfg, conv, m in (
            (tmp_path / "ours", vis, load_cfg("torch", opts=opts), _nchw, tmeta),
            (tmp_path / "jax", jvis, load_cfg("jax", opts=opts), lambda a: a, meta)):
        root.mkdir()
        mod.save_debug_images(cfg, conv(images), m, conv(heatmaps), preds,
                              conv(heatmaps[::-1].copy()), str(root / "dbg"))
        mod.save_batch_image_with_joints(conv(images), preds, meta["joints_vis"],
                                         str(root / "grid.jpg"), nrow=2)
    names = _same_images(tmp_path / "ours", tmp_path / "jax")
    assert len(names) == 8     # gt, pred, hm_gt, hm_pred, grid and 3 IoU-bin dumps

    rng = np.random.RandomState(3)
    canvas = rng.randint(0, 256, (120, 160, 3), np.uint8)
    kps = np.concatenate([rng.uniform(5, [155, 115], (J, 2)), rng.uniform(-1, 1, (J, 1))], 1)
    np.testing.assert_array_equal(vis_coco.coco_vis_keypoints(canvas, kps),
                                  jvc.coco_vis_keypoints(canvas, kps))
    np.testing.assert_array_equal(vis_coco.vis_keypoints(canvas, kps.T, kp_thresh=0.0),
                                  jvc.vis_keypoints(canvas, kps.T, kp_thresh=0.0))
    for dataset, n in (("coco", J), ("crowdpose", 14)):
        np.testing.assert_array_equal(
            skeletons.plot_keypoints(canvas.copy(), kps[:n], dataset, (0, 255, 0)),
            jsk.plot_keypoints(canvas.copy(), kps[:n], dataset, (0, 255, 0)))


def test_validate_writes_debug_images(tmp_path):
    """validate with DEBUG.DEBUG on the tiny CoAM: each logged batch's four
    images, the ones JAX's save_debug_images makes of that batch and of the
    port's heatmaps (their argmax times the stride as the predictions)."""
    from test_data_pipeline import _tiny_coco
    from test_torch_port_config import load_cfg
    from test_torch_port_eval import _crowdpose_eval_opts, _Replay

    from buctd_tpu.utils.vis import save_debug_images as jax_save_debug_images
    from buctd_tpu_torch.core.function import make_validate_step, validate
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.device_pipeline import DeviceLoader
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.ops.decode import get_max_preds

    ann_file, _ = _tiny_coco(tmp_path, n_imgs=2, people=2, J=14)
    opts = _crowdpose_eval_opts(tmp_path, ann_file) + [
        "DEBUG.DEBUG", "True", "DEBUG.SAVE_BATCH_IMAGES_GT", "True",
        "DEBUG.SAVE_BATCH_IMAGES_PRED", "True", "DEBUG.SAVE_HEATMAPS_GT", "True",
        "DEBUG.SAVE_HEATMAPS_PRED", "True"]
    cfg = load_cfg("torch", opts=opts)
    torch.manual_seed(0)
    model = get_model(cfg, device="cpu")
    ds = get_dataset(cfg, is_train=False)
    loader = DeviceLoader(ds, cfg, num_workers=1, device="cpu")
    batches = list(loader)
    loader.close()
    validate(cfg, _Replay(batches), ds, model, tmp_path / "ours", epoch=0, print_prefix="_r0")
    step = make_validate_step(cfg, model, ds.flip_pairs, ds.kpt_colors)
    (tmp_path / "jax").mkdir()
    jcfg = load_cfg("jax", opts=opts)
    for i, batch in enumerate(batches):
        hm = step(batch)[5]
        pred, _ = get_max_preds(hm)
        nhwc = {k: (v.permute(0, 2, 3, 1).numpy() if k in ("input", "target") else v)
                for k, v in batch.items()}
        jax_save_debug_images(jcfg, nhwc["input"], nhwc, nhwc["target"],
                              pred.numpy() * 4.0, hm.permute(0, 2, 3, 1).numpy(),
                              str(tmp_path / "jax" / f"val_epoch_000000000_iter_{i}_r0"))
    assert len(_same_images(tmp_path / "ours", tmp_path / "jax")) == 8
