"""buctd_tpu_torch evaluation vs buctd_tpu, on the CPU at tiny size.

* NMS: ``oks_iou`` to rtol 1e-12 (the same float64 numpy expression); the
  greedy and soft OKS-NMS, ``rescore``, ``oks_merge``, box ``nms`` and
  ``box_nms_torch`` (vs ``box_nms_jax``) keep the same indices.
* ``COCOKeypointEval``: COCO and CrowdPose stats to 1e-12 on the same gt/dt
  (the same float64 numpy); ``COCOIndex.loadRes`` builds the same index.
* The three test-time dbs (BU prediction json, pose results, detector
  pickle), field for field.
* The validate step (flip test, colored / plain / stacked conditions, flip on
  and off) on a tiny CoAM with the JAX weights carried by ``from_flax``:
  heatmaps within 1e-5 x the peak (f32 convs and attention summed in another
  order); predictions within 1e-3 px where the decode margin is at least
  MARGIN (as tests/test_torch_port_serving.py: an argmax and the sign of a
  neighbour difference only move where the maps are that close to a tie);
  maxvals and the loss rtol 1e-5; the PCK accuracy equal.
* ``evaluate`` fed the same predictions in both packages: the same results
  json and AP within 1e-6.  ``validate`` + ``evaluate`` end to end on the
  same batches (the port loader's, whose eval batches carry the meta
  validate reads and repeat the last sample in their pad rows): keypoints
  within 1e-3 px, AP within 1e-3.
* ``valid.run.main`` on the CPU with TEST.REFINE_ITERS 2 writes both rounds'
  results, round 1 reading round 0's.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_data_pipeline import _tiny_coco
from test_torch_port_config import COAM_YAML, TINY_COAM, jax_variables, load_cfg

MARGIN = 5e-4
J = 14


# ------------------------------------------------------------------- NMS ----
def _kpts_db(rng, n):
    base = rng.uniform(20, 200, (J, 2))
    db = []
    for _ in range(n):
        kp = np.concatenate([base + rng.randn(J, 2) * rng.uniform(1, 30),
                             rng.uniform(0, 1, (J, 1))], 1)
        db.append({"keypoints": kp, "score": float(rng.uniform(0.1, 1)),
                   "area": float(rng.uniform(2000, 9000))})
    return db


@pytest.mark.parametrize("seed", range(3))
def test_nms_family_matches_jax(seed):
    from buctd_tpu.ops import nms as jnms
    from buctd_tpu_torch.ops import nms

    rng = np.random.RandomState(seed)
    db = _kpts_db(rng, 12)
    sig = rng.uniform(0.02, 0.1, J)
    flat = np.array([d["keypoints"].ravel() for d in db])
    areas = np.array([d["area"] for d in db])
    for thr in (None, 0.3):
        np.testing.assert_allclose(
            nms.oks_iou(flat[0], flat[1:], areas[0], areas[1:], sig, thr),
            jnms.oks_iou(flat[0], flat[1:], areas[0], areas[1:], sig, thr), rtol=1e-12)
        for t in (0.3, 0.6, 0.9):
            assert nms.oks_nms(db, t, sig, thr) == jnms.oks_nms(db, t, sig, thr)
            np.testing.assert_array_equal(nms.soft_oks_nms(db, t, sig, thr),
                                          jnms.soft_oks_nms(db, t, sig, thr))
    ovr, scores = rng.uniform(0, 1, 9), rng.uniform(0, 1, 9)
    for kind in ("gaussian", "linear"):
        np.testing.assert_array_equal(nms.rescore(ovr, scores, 0.5, kind),
                                      jnms.rescore(ovr, scores, 0.5, kind))
    merged, jmerged = (m.oks_merge(db[:5], db[5:], 0.5, sig) for m in (nms, jnms))
    assert [id(r) for r in merged] == [id(r) for r in jmerged]

    xy = rng.uniform(0, 300, (40, 2))
    dets = np.concatenate([xy, xy + rng.uniform(10, 80, (40, 2)),
                           rng.uniform(0, 1, (40, 1))], 1).astype(np.float32)
    for t in (0.3, 0.5, 0.7):
        assert nms.nms(dets, t) == jnms.nms(dets, t)
        np.testing.assert_array_equal(nms.box_nms_torch(torch.from_numpy(dets), t),
                                      jnms.box_nms_jax(dets, t))
    assert len(nms.box_nms_torch(np.zeros((0, 5), np.float32), 0.5)) == 0


# ------------------------------------------------------------- COCOeval ----
def _gt_dt(rng, n_img=4, people=3):
    images, anns, dts = [], [], []
    for i in range(n_img):
        images.append({"id": i + 1, "file_name": f"im{i}.png", "width": 320,
                       "height": 240, "crowdIndex": float(rng.choice([0.05, 0.5, 0.9]))})
        for p in range(people):
            xy = rng.uniform(20, 220, (J, 2))
            vis = (rng.rand(J) > 0.2) * 2
            kps = np.concatenate([xy, vis[:, None]], 1).ravel().tolist()
            w, h = float(np.ptp(xy[:, 0]) + 10), float(np.ptp(xy[:, 1]) + 10)
            anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": 1,
                         "iscrowd": int(p == 2 and i == 0), "keypoints": kps,
                         "num_keypoints": int((vis > 0).sum()),
                         "bbox": [float(xy[:, 0].min()), float(xy[:, 1].min()), w, h],
                         "area": w * h * rng.uniform(0.3, 1.5)})
            for _ in range(2):
                d = np.concatenate([xy + rng.randn(J, 2) * rng.uniform(1, 25),
                                    rng.uniform(0, 1, (J, 1))], 1)
                dts.append({"image_id": i + 1, "category_id": 1,
                            "keypoints": d.ravel().tolist(),
                            "score": float(rng.uniform(0, 1))})
    return ({"images": images, "annotations": anns,
             "categories": [{"id": 1, "name": "person"}]}, dts)


def test_cocoeval_and_load_res_match_jax(tmp_path):
    from buctd_tpu.data import coco_eval as jce
    from buctd_tpu.data.coco_io import COCOIndex as JIndex
    from buctd_tpu_torch.data import coco_eval as ce
    from buctd_tpu_torch.data.coco_io import COCOIndex

    gt, dts = _gt_dt(np.random.RandomState(0))
    res_file = tmp_path / "res.json"
    res_file.write_text(json.dumps(dts))
    ours, theirs = COCOIndex(gt).loadRes(str(res_file)), JIndex(gt).loadRes(str(res_file))
    assert ours.dataset == theirs.dataset
    assert ours.anns == theirs.anns and dict(ours.imgToAnns) == dict(theirs.imgToAnns)

    sig = np.random.RandomState(1).uniform(0.02, 0.1, J)
    bins = {"easy": (0.0, 0.1), "medium": (0.1, 0.8), "hard": (0.8, 1.01)}
    for area_rngs, crowd in ((None, None), ({"all": (0.0, 1e10)}, bins)):
        stats = []
        for mod, index in ((ce, COCOIndex), (jce, JIndex)):
            g = index(json.loads(json.dumps(gt)))
            ev = mod.COCOKeypointEval(g, g.loadRes(str(res_file)), sig,
                                      area_rngs=area_rngs, crowd_index_bins=crowd)
            ev.evaluate()
            ev.accumulate()
            stats.append(ev.summarize())
        assert len(stats[0]) == (9 if crowd else 10)
        assert 0.0 < stats[0][0] < 1.0
        np.testing.assert_allclose(stats[0], stats[1], rtol=0, atol=1e-12)
    assert ce.CROWDPOSE_STATS_NAMES == jce.CROWDPOSE_STATS_NAMES
    assert ce.COCO_STATS_NAMES == jce.COCO_STATS_NAMES
    assert ce.COCO_AREA_RNGS == jce.COCO_AREA_RNGS


# ------------------------------------------------------------- test dbs ----
def _eval_opts(tmp_path, ann_file, *extra):
    return ["DATASET.TEST_IMAGE_DIR", str(tmp_path), "DATASET.TEST_ANNOTATION_FILE",
            ann_file, *extra]


def _datasets(opts, yaml=COAM_YAML):
    from buctd_tpu.data import get_dataset as jax_dataset
    from buctd_tpu_torch.data.datasets import get_dataset

    return (get_dataset(load_cfg("torch", yaml, opts), is_train=False),
            jax_dataset(load_cfg("jax", yaml, opts), is_train=False))


def _assert_same_db(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for key in a:
            if isinstance(a[key], (np.ndarray, list, tuple)):
                np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                              err_msg=key)
            else:
                assert a[key] == b[key], key


def _bu_json(tmp_path, gt, rng):
    preds_json = []
    for img in gt["images"]:
        people = [a for a in gt["annotations"] if a["image_id"] == img["id"]]
        preds, scores = [], []
        for ann in people:
            kp = np.array(ann["keypoints"], np.float64).reshape(-1, 3)
            kp[:, :2] += rng.randn(J, 2) * 4
            kp[:, 2] = rng.uniform(0, 1, J)
            kp[rng.rand(J) < 0.15] = 0          # undetected joints
            preds.append(kp.tolist())
            scores.append(float(rng.uniform(0.3, 1)))
        preds.append(np.zeros((J, 3)).tolist())  # a fully undetected pose: skipped
        scores.append(0.9)
        preds.append((np.array(preds[0]) + 3.0).tolist())
        scores.append(0.01)                      # under IMAGE_THRE
        preds_json.append({"preds": preds, "scores": scores,
                           "image_paths": [str(tmp_path / img["file_name"])]})
    path = tmp_path / "bu.json"
    path.write_text(json.dumps(preds_json))
    return str(path)


def test_test_time_dbs_match_jax(tmp_path):
    ann_file, gt = _tiny_coco(tmp_path, n_imgs=3, people=2, J=J)
    rng = np.random.RandomState(4)
    bu = _bu_json(tmp_path, gt, rng)
    _assert_same_db(*(ds.db for ds in _datasets(_eval_opts(
        tmp_path, ann_file, "TEST.COCO_BBOX_FILE", bu, "TEST.IMAGE_THRE", "0.1"))))

    poses = [{"image_id": a["image_id"], "category_id": 1, "score": float(rng.uniform()),
              "keypoints": (np.array(a["keypoints"]) * np.tile([1.01, 0.99, 0.5], J)
                            ).tolist()} for a in gt["annotations"]]
    poses.append({"image_id": 1, "category_id": 1, "score": 0.5,
                  "keypoints": [0.0] * (3 * J)})  # no joint: skipped
    pose_file = tmp_path / "poses.json"
    pose_file.write_text(json.dumps(poses))
    _assert_same_db(*(ds.db for ds in _datasets(_eval_opts(
        tmp_path, ann_file, "TEST.COCO_BBOX_FILE", str(pose_file)))))

    dets = [[np.array([[10, 10, 120, 200, 0.95], [150, 20, 300, 220, 0.05],
                       [140, 25, 290, 215, 0.6]], np.float32)] for _ in gt["images"]]
    pkl = tmp_path / "dets.pkl"
    pkl.write_bytes(pickle.dumps(dets))
    _assert_same_db(*(ds.db for ds in _datasets(_eval_opts(
        tmp_path, ann_file, "TEST.COCO_BBOX_FILE", str(pkl), "TEST.USE_BU_BBOX", "False",
        "MODEL.CONDITIONAL_TOPDOWN", "False"))))


# ------------------------------------------------------------- evaluate ----
@pytest.mark.parametrize("case", ["crowdpose_gt_db", "coco_dets_nms", "coco_dets_soft_nms"])
def test_evaluate_matches_jax(tmp_path, case):
    """The same predictions through both packages' evaluate: the results json
    and every stat.  CrowdPose from the GT db (box area, no NMS); COCO from a
    detector pickle (17 joints, OKS-NMS and soft OKS-NMS really run)."""
    coco = case.startswith("coco")
    joints = 17 if coco else J
    ann_file, gt = _tiny_coco(tmp_path, n_imgs=3, people=2, J=joints)
    extra = []
    if coco:
        dets = []
        for img in gt["images"]:
            boxes = []
            for a in gt["annotations"]:
                if a["image_id"] == img["id"]:
                    x, y, w, h = a["bbox"]
                    boxes += [[x, y, x + w, y + h, 0.9], [x + 4, y - 3, x + w + 2, y + h, 0.7]]
            dets.append([np.array(boxes, np.float32)])
        pkl = tmp_path / "dets.pkl"
        pkl.write_bytes(pickle.dumps(dets))
        extra = ["DATASET.DATASET", "coco", "MODEL.NUM_JOINTS", "17",
                 "TEST.COCO_BBOX_FILE", str(pkl), "TEST.USE_BU_BBOX", "False",
                 "MODEL.CONDITIONAL_TOPDOWN", "False", "TRAIN.USE_BU_BBOX", "False",
                 "TEST.OKS_THRE", "0.5",
                 "TEST.IN_VIS_THRE", "0.2", "TEST.SOFT_NMS", str(case.endswith("soft_nms"))]
    opts = _eval_opts(tmp_path, ann_file, *extra)
    ours, theirs = _datasets(opts)
    cfg, jcfg = load_cfg("torch", COAM_YAML, opts), load_cfg("jax", COAM_YAML, opts)

    rng = np.random.RandomState(7)
    kps = {a["image_id"]: [] for a in gt["annotations"]}
    for a in gt["annotations"]:
        kps[a["image_id"]].append(np.array(a["keypoints"], np.float64).reshape(-1, 3))
    preds, boxes, paths = [], [], []
    for rec in ours.db:
        image_id = next(i["id"] for i in gt["images"] if rec["image"].endswith(i["file_name"]))
        near = min(kps[image_id], key=lambda k: np.abs(k[:, :2].mean(0) - rec["center"]).sum())
        p = near.copy()
        p[:, :2] += rng.randn(joints, 2) * rng.uniform(1, 12)
        p[:, 2] = rng.uniform(0, 1, joints)
        preds.append(p)
        c, s = rec["center"], rec["scale"]
        boxes.append([c[0], c[1], s[0], s[1], np.prod(np.asarray(s) * 200),
                      rec.get("score", 1), rec.get("annotation_id", 0)])
        paths.append(rec["image"])
    preds, boxes = np.array(preds), np.array(boxes)
    got_nv, got_ap = ours.evaluate(cfg, preds, str(tmp_path / "ours"), boxes, paths, 3)
    want_nv, want_ap = theirs.evaluate(jcfg, preds, str(tmp_path / "jax"), boxes, paths, 3)
    name = "results/keypoints_test_results_epoch3.json"
    got_json = json.loads((tmp_path / "ours" / name).read_text())
    assert got_json == json.loads((tmp_path / "jax" / name).read_text())
    if case == "coco_dets_nms":
        assert len(got_json) < len(preds)    # NMS removed duplicates
    assert 0.0 < got_ap < 1.0
    assert list(got_nv) == list(want_nv)
    np.testing.assert_allclose(list(got_nv.values()), list(want_nv.values()), atol=1e-6)
    assert abs(got_ap - want_ap) <= 1e-6


# -------------------------------------------------------- validate step ----
def _margins(hm):
    """Per (sample, joint): the smallest of the top-two gap and the
    |neighbour differences| at the argmax, what a decode depends on."""
    B, Jn, h, w = hm.shape
    flat = hm.reshape(B * Jn, h * w)
    top2 = flat.topk(2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    idx = flat.argmax(dim=1)
    py, px = idx // w, idx % w
    r = torch.arange(B * Jn)
    m = hm.reshape(B * Jn, h, w)
    dx = (m[r, py, (px + 1).clamp(max=w - 1)] - m[r, py, (px - 1).clamp(min=0)]).abs()
    dy = (m[r, (py + 1).clamp(max=h - 1), px] - m[r, (py - 1).clamp(min=0), px]).abs()
    inb = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    return torch.where(inb, torch.minimum(gap, torch.minimum(dx, dy)), gap).reshape(B, Jn)


def _step_batch(rng, B, C, h_img=128, w_img=96):
    x = rng.randn(B, h_img, w_img, C).astype(np.float32)
    cj = np.concatenate([rng.uniform(2, [w_img - 2, h_img - 2], (B, J, 2)),
                         np.zeros((B, J, 1))], -1).astype(np.float32)
    cv = np.repeat((rng.rand(B, J, 1) > 0.25).astype(np.float32), 3, -1)
    return {"input": x, "cond_joints": cj, "cond_joints_vis": cv,
            "target": (rng.rand(B, 32, 24, J) > 0.995).astype(np.float32),
            "target_weight": (rng.rand(B, J) > 0.2).astype(np.float32),
            "center": rng.uniform(80, 200, (B, 2)).astype(np.float32),
            "scale": rng.uniform(0.5, 1.2, (B, 2)).astype(np.float32)}


@pytest.mark.parametrize("flip", [True, False], ids=["flip", "noflip"])
@pytest.mark.parametrize("mode", ["colored", "plain", "stacked"])
def test_validate_step_matches_jax(mode, flip):
    from buctd_tpu.core.function import _make_validate_step
    from buctd_tpu.data.datasets.crowdpose import CrowdPoseDataset as JaxCrowdPose
    from buctd_tpu.data.joints_dataset import rainbow_colors
    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.core.function import make_validate_step
    from buctd_tpu_torch.models import get_model

    opts = TINY_COAM + ["TEST.FLIP_TEST", str(flip),
                        "DATASET.COLORED", str(mode == "colored"),
                        "DATASET.STACKED_CONDITION", str(mode == "stacked")]
    jcfg, cfg = load_cfg("jax", opts=opts), load_cfg("torch", opts=opts)
    C = 3 + J if mode == "stacked" else 6
    jmodel, variables = jax_variables(jcfg, seed=2, channels=C)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(from_flax(variables), strict=True)
    flip_pairs, colors = JaxCrowdPose.flip_pairs, rainbow_colors(J)
    batch = _step_batch(np.random.RandomState(3), 3, C)

    jstep = _make_validate_step(jcfg, jmodel, flip_pairs, colors)
    with jax.disable_jit():
        want = jstep(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    jp, jm, jloss, jacc, jcnt, jhm = (np.asarray(t) for t in want)

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["input"] = tb["input"].permute(0, 3, 1, 2).contiguous()
    tb["target"] = tb["target"].permute(0, 3, 1, 2).contiguous()
    for k in ("cond_joints", "cond_joints_vis", "center", "scale"):
        tb[k] = batch[k]                                   # numpy meta, as the loader's
    p, m, loss, acc, cnt, hm = make_validate_step(cfg, model, flip_pairs, colors)(tb)

    peak = float(np.abs(jhm).max())
    np.testing.assert_allclose(hm.permute(0, 2, 3, 1).numpy(), jhm, rtol=0, atol=1e-5 * peak)
    ok = (_margins(hm) >= MARGIN).numpy()
    assert ok.mean() > 0.9, ok.mean()
    np.testing.assert_allclose(p.numpy()[ok], jp[ok], rtol=0, atol=1e-3)
    np.testing.assert_allclose(m.numpy(), jm, rtol=1e-5, atol=1e-5 * peak)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(acc) == float(jacc) and int(cnt) == int(jcnt)


# ------------------------------------------------------ validate + runs ----
class _Replay:
    """A loader that replays stored batches (len() and iteration)."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _crowdpose_eval_opts(tmp_path, ann_file):
    return TINY_COAM + _eval_opts(tmp_path, ann_file, "TPU.DEVICE_PIPELINE", "True",
                                  "TEST.BATCH_SIZE_PER_GPU", "3", "WORKERS", "1",
                                  "PRINT_FREQ", "1")


def test_validate_end_to_end_matches_jax(tmp_path):
    """The port's validate + evaluate on the port loader's batches vs JAX's
    validate + evaluate on the same batches (NHWC), same weights."""
    from buctd_tpu.core.function import validate as jax_validate
    from buctd_tpu.data import get_dataset as jax_dataset
    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.core.function import make_validate_step, validate
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.device_pipeline import DeviceLoader
    from buctd_tpu_torch.models import get_model

    ann_file, _ = _tiny_coco(tmp_path, n_imgs=2, people=2, J=J)
    opts = _crowdpose_eval_opts(tmp_path, ann_file)
    cfg, jcfg = load_cfg("torch", opts=opts), load_cfg("jax", opts=opts)
    jmodel, variables = jax_variables(jcfg, seed=6)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(from_flax(variables), strict=True)
    ds, jds = get_dataset(cfg, is_train=False), jax_dataset(jcfg, is_train=False)
    loader = DeviceLoader(ds, cfg, num_workers=1, device="cpu")
    batches = list(loader)
    loader.close()
    assert len(batches) == 2 and batches[1]["valid"].sum() == 1
    # an eval batch carries what validate reads; pad rows repeat the last sample
    for key in ("score", "annotation_id", "center", "scale", "cond_joints",
                "cond_joints_vis", "db_index", "valid", "image_path"):
        assert len(batches[1][key]) == 3, key
    pad = batches[1]
    assert list(pad["db_index"]) == [3, 3, 3] and list(pad["valid"]) == [1, 0, 0]
    assert len(set(pad["image_path"])) == 1
    torch.testing.assert_close(pad["input"][1:], pad["input"][:1].expand(2, -1, -1, -1))

    step = make_validate_step(cfg, model, ds.flip_pairs, ds.kpt_colors)
    assert min(float(_margins(step(b)[5]).min()) for b in batches) > MARGIN
    stats = {}
    nv, ap = validate(cfg, _Replay(batches), ds, model, tmp_path / "ours", epoch=0,
                      stats=stats)
    assert stats["crops"] == 4 and stats["loop_s"] > 0

    def to_jax(b):
        out = dict(b)
        out["input"] = b["input"].permute(0, 2, 3, 1).numpy()
        out["target"] = b["target"].permute(0, 2, 3, 1).numpy()
        out["target_weight"] = b["target_weight"].numpy()
        return out

    jnv, jap = jax_validate(jcfg, _Replay([to_jax(b) for b in batches]), jds, jmodel,
                            variables, str(tmp_path / "jax"), epoch=0)
    name = "results/keypoints_test_results_epoch0.json"
    got = json.loads((tmp_path / "ours" / name).read_text())
    want = json.loads((tmp_path / "jax" / name).read_text())
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.reshape(g["keypoints"], (J, 3))[:, :2],
                                   np.reshape(w["keypoints"], (J, 3))[:, :2], atol=1e-3)
        assert g["image_id"] == w["image_id"]
        assert g["annotation_id"] == w["annotation_id"]
    assert 0.0 <= ap <= 1.0 and abs(ap - jap) <= 1e-3
    assert list(nv) == list(jnv)


def test_valid_run_refines_in_process(tmp_path):
    """valid.run.main on the CPU, TEST.REFINE_ITERS 2: round 0 reads the GT
    db's conditions, round 1 the results json round 0 wrote."""
    from buctd_tpu_torch.valid import run

    ann_file, _ = _tiny_coco(tmp_path, n_imgs=2, people=2, J=J)
    out = tmp_path / "out"
    res = run.main(["--cfg", str(COAM_YAML), "--device", "cpu",
                    *_crowdpose_eval_opts(tmp_path, ann_file), "TEST.REFINE_ITERS", "2",
                    "OUTPUT_DIR", str(out)])
    assert len(res["ap"]) == 2 and all(0.0 <= ap <= 1.0 for ap in res["ap"])
    results = res["output_dir"] / "results"
    for it in range(2):
        rows = json.loads((results / f"keypoints_test_results_epoch{it}.json").read_text())
        assert len(rows) == 4 == res["rounds"][it]["crops"]
    r0 = json.loads((results / "keypoints_test_results_epoch0.json").read_text())
    r1 = json.loads((results / "keypoints_test_results_epoch1.json").read_text())
    # round 1's boxes come from round 0's keypoints: its centers moved
    assert any(a["center"] != b["center"] for a, b in zip(r0, r1))
    # the lambda sweep runs (tests/test_torch_port_lambda.py holds it to JAX)
    lam = run.main(["--cfg", str(COAM_YAML), "--device", "cpu",
                    *_crowdpose_eval_opts(tmp_path, ann_file), "TEST.LAMBDA_SWEEP", "True",
                    "OUTPUT_DIR", str(out)])
    assert 0.0 <= lam["ap"][0] <= 1.0 and lam["rounds"][0]["crops"] == 8
    for kind in ("l0", "l1", "merged"):
        assert (results / f"keypoints_test_results_epoch0_{kind}.json").exists()
