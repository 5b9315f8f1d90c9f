"""buctd_tpu_torch's lambda sweeps vs buctd_tpu's, on the CPU at tiny widths.

* ``validate_lambda_quantitative`` (``TEST.LAMBDA_SWEEP``) on the port
  loader's batches of a tiny CrowdPose set (4 crops, batches of 3), run by
  both packages with the same weights: a tiny CoAM (no lambda head: both
  passes run the same forward) and a tiny preNet HRNet with the lambda head
  (lambda moves its heatmaps).  The (N, 8) ``all_boxes`` that reach
  ``evaluate`` are equal, lambda 0's scores are lambda 1's times
  ``TEST.DECAY_THRE``; the ``_l0``, ``_l1`` and ``_merged`` jsons hold the
  same detections in the same order, keypoints within 1e-3 px and scores
  within 1e-5 (f32 heatmaps summed in another order, as
  tests/test_torch_port_eval.py's end-to-end test holds them); the three AP
  tables within 1e-3.
* ``evaluate_lambda`` on fixed predictions: the three jsons equal JAX's, and
  the AP tables, bit for bit; CrowdPose from the GT db and COCO from a
  detector pickle, where OKS-NMS and the merge's OKS really run.
* ``validate_lambda``'s {lambda: (loss, acc)} over the six lambdas: the
  losses within 1e-5 relative, the accuracies equal.
* The legacy step mirrors the whole input; ``make_validate_step``'s flip test
  re-renders the condition: the two must differ (the control), and without
  the flip test they run the same forward.  Under ``TPU.EVAL_DTYPE
  bfloat16`` the lambda step takes the same autocast (its outputs equal the
  bf16 validate step's, bf16).
* ``TEST.LAMBDA_SWEEP`` with ``TEST.REFINE_ITERS`` 3 raises, as
  tools/test.py:95-98.
"""

import json

import numpy as np
import pytest
import torch

from test_data_pipeline import _tiny_coco
from test_torch_port_config import COAM_YAML, TINY_COAM, jax_variables, load_cfg
from test_torch_port_eval import _Replay, _datasets, _eval_opts
from test_torch_port_prenet import PRENET_YAML
from test_torch_port_prenet import TINY as TINY_PRENET
from test_torch_port_prenet import _variables as prenet_variables

J = 14
KPT_ATOL = 1e-3
AP_ATOL = 1e-3
MODELS = {"coam": (COAM_YAML, TINY_COAM), "prenet_lambda": (PRENET_YAML, TINY_PRENET)}


def _opts(tmp_path, ann_file, name, *extra):
    return MODELS[name][1] + _eval_opts(
        tmp_path, ann_file, "TPU.DEVICE_PIPELINE", "True", "TEST.BATCH_SIZE_PER_GPU", "3",
        "WORKERS", "1", "PRINT_FREQ", "1", "TEST.DECAY_THRE", "0.7", *extra)


def _setup(tmp_path, name, *extra):
    """(port cfg, JAX cfg, port model, JAX model, variables, port dataset,
    JAX dataset, the port loader's batches)."""
    from buctd_tpu.data import get_dataset as jax_dataset
    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.device_pipeline import DeviceLoader
    from buctd_tpu_torch.models import get_model

    ann_file, _ = _tiny_coco(tmp_path, n_imgs=2, people=2, J=J)
    yaml = MODELS[name][0]
    opts = _opts(tmp_path, ann_file, name, *extra)
    cfg, jcfg = load_cfg("torch", yaml, opts), load_cfg("jax", yaml, opts)
    lam = name == "prenet_lambda"
    jmodel, variables = (prenet_variables(jcfg, seed=8, lam=True) if lam
                         else jax_variables(jcfg, seed=6))
    model = get_model(cfg, device="cpu", lambda_head=lam)
    model.load_state_dict(from_flax(variables), strict=True)
    ds, jds = get_dataset(cfg, is_train=False), jax_dataset(jcfg, is_train=False)
    loader = DeviceLoader(ds, cfg, num_workers=1, device="cpu")
    batches = list(loader)
    loader.close()
    return cfg, jcfg, model, jmodel, variables, ds, jds, batches


def _to_jax(b):
    out = dict(b)
    out["input"] = b["input"].permute(0, 2, 3, 1).numpy()
    out["target"] = b["target"].permute(0, 2, 3, 1).numpy()
    out["target_weight"] = b["target_weight"].numpy()
    return out


def _spy(ds):
    """Record what ``ds.evaluate`` is given and returns."""
    seen = {}
    evaluate = ds.evaluate

    def spy(cfg, preds, output_dir, all_boxes, img_path, epoch=-1):
        seen["boxes"] = np.array(all_boxes)
        seen["out"] = evaluate(cfg, preds, output_dir, all_boxes, img_path, epoch)
        return seen["out"]

    ds.evaluate = spy
    return seen


def _results(root, kind):
    name = f"results/keypoints_test_results_epoch0_{kind}.json"
    return json.loads((root / name).read_text())


def _assert_same_detections(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["image_id"], g["annotation_id"]) == (w["image_id"], w["annotation_id"])
        np.testing.assert_allclose(np.reshape(g["keypoints"], (J, 3))[:, :2],
                                   np.reshape(w["keypoints"], (J, 3))[:, :2], atol=KPT_ATOL)
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", list(MODELS))
def test_validate_lambda_quantitative_matches_jax(tmp_path, name):
    from buctd_tpu.core.function import validate_lambda_quantitative as jax_sweep
    from buctd_tpu_torch.core.function import validate_lambda_quantitative

    cfg, jcfg, model, jmodel, variables, ds, jds, batches = _setup(tmp_path, name)
    assert len(batches) == 2 and model.__class__.__name__ in ("PoseHRNetCoAM", "PoseHRNet")
    seen, jseen = _spy(ds), _spy(jds)
    stats = {}
    ap = validate_lambda_quantitative(cfg, _Replay(batches), ds, model, tmp_path / "ours",
                                      epoch=0, stats=stats)
    jap = jax_sweep(jcfg, _Replay([_to_jax(b) for b in batches]), jds, jmodel, variables,
                    str(tmp_path / "jax"), epoch=0)
    assert stats["crops"] == 8                    # 4 crops x lambda 0 and 1
    boxes = seen["boxes"]
    np.testing.assert_array_equal(boxes, jseen["boxes"])
    assert boxes.shape == (8, 8) and list(boxes[:, 7]) == [0, 0, 0, 1, 1, 1, 0, 1]
    lam0, lam1 = boxes[boxes[:, 7] == 0], boxes[boxes[:, 7] == 1]
    np.testing.assert_allclose(lam0[:, 5], lam1[:, 5] * 0.7, rtol=1e-7)   # lambda 0 decays
    for kind in ("l0", "l1", "merged"):
        _assert_same_detections(_results(tmp_path / "ours", kind),
                                _results(tmp_path / "jax", kind))
    for got, want in zip(seen["out"][:3], jseen["out"][:3]):
        assert list(got) == list(want)
        np.testing.assert_allclose(list(got.values()), list(want.values()), atol=AP_ATOL)
    assert 0.0 <= ap <= 1.0 and abs(ap - jap) <= AP_ATOL
    l0 = [r["keypoints"] for r in _results(tmp_path / "ours", "l0")]
    l1 = [r["keypoints"] for r in _results(tmp_path / "ours", "l1")]
    if name == "prenet_lambda":                   # the head makes lambda matter
        assert not np.allclose(l0, l1)
    else:
        np.testing.assert_array_equal(l0, l1)


def _modes(preds, boxes, rng):
    """Mode 1: the predictions; mode 0: the same, half moved far (OKS-disjoint,
    kept by the merge) and half moved a little (suppressed by it), decayed."""
    p0 = preds.copy()
    far = np.arange(len(p0)) % 2 == 0
    p0[far, :, :2] += 60.0
    p0[~far, :, :2] += rng.randn((~far).sum(), preds.shape[1], 2)
    b0 = boxes.copy()
    b0[:, 5] *= 0.5
    all_boxes = np.concatenate([np.c_[b0, np.zeros(len(b0))], np.c_[boxes, np.ones(len(boxes))]])
    return np.concatenate([p0, preds]), all_boxes


@pytest.mark.parametrize("case", ["crowdpose_gt_db", "coco_dets_nms"])
def test_evaluate_lambda_matches_jax_bit_for_bit(tmp_path, case):
    import pickle

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
                 "TEST.OKS_THRE", "0.5", "TEST.IN_VIS_THRE", "0.2"]
    opts = _eval_opts(tmp_path, ann_file, *extra)
    ours, theirs = _datasets(opts)
    cfg, jcfg = load_cfg("torch", COAM_YAML, opts), load_cfg("jax", COAM_YAML, opts)
    rng = np.random.RandomState(9)
    kps = {}
    for a in gt["annotations"]:
        kps.setdefault(a["image_id"], []).append(
            np.array(a["keypoints"], np.float64).reshape(-1, 3))
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
    preds, all_boxes = _modes(np.array(preds), np.array(boxes), rng)
    paths = paths + paths
    got = ours.evaluate(cfg, preds, str(tmp_path / "ours"), all_boxes, paths, 0)
    want = theirs.evaluate(jcfg, preds, str(tmp_path / "jax"), all_boxes, paths, 0)
    for kind in ("l0", "l1", "merged"):
        g, w = _results(tmp_path / "ours", kind), _results(tmp_path / "jax", kind)
        assert g == w, kind
    merged, l0, l1 = (_results(tmp_path / "ours", k) for k in ("merged", "l0", "l1"))
    assert len(l1) < len(merged) <= len(l0) + len(l1)    # the merge kept mode-0 poses
    if not coco:                                  # ... and dropped the near ones
        assert len(merged) < len(l0) + len(l1)
    for g, w in zip(got[:3], want[:3]):
        assert list(g) == list(w) and list(g.values()) == list(w.values())
    assert got[3] == want[3] and 0.0 < got[3] < 1.0


def test_validate_lambda_matches_jax(tmp_path):
    from buctd_tpu.core.function import validate_lambda as jax_validate_lambda
    from buctd_tpu_torch.core.function import validate_lambda

    cfg, jcfg, model, jmodel, variables, ds, jds, batches = _setup(tmp_path, "prenet_lambda")
    got = validate_lambda(cfg, _Replay(batches), ds, model)
    want = jax_validate_lambda(jcfg, _Replay([_to_jax(b) for b in batches]), jds, jmodel,
                               variables)
    assert list(got) == list(want) == [0, 0.2, 0.4, 0.6, 0.8, 1.0]
    for lam in got:
        np.testing.assert_allclose(got[lam][0], want[lam][0], rtol=1e-5)
        assert abs(got[lam][1] - want[lam][1]) <= 1e-6
    assert len({round(v[0], 9) for v in got.values()}) > 1     # the head responds to lambda


def test_legacy_flip_differs_from_flip_hm_and_takes_the_eval_dtype(tmp_path):
    from buctd_tpu_torch.core.function import make_validate_lambda_step, make_validate_step

    cfg, _, model, _, _, ds, _, batches = _setup(tmp_path, "coam")
    batch = batches[0]
    lam = torch.tensor([[0.0, 1.0]]).expand(3, 2)
    legacy = make_validate_lambda_step(cfg, model, ds.flip_pairs, use_lambda=False)
    p, m, loss, _, _ = legacy(batch, lam)
    hp, hm_, hloss, _, _, _ = make_validate_step(cfg, model, ds.flip_pairs,
                                                 ds.kpt_colors)(batch)
    assert not torch.allclose(m, hm_, rtol=0, atol=1e-4)      # the control
    for bf16 in (False, True):
        extra = ["TEST.FLIP_TEST", "False"] + (["TPU.EVAL_DTYPE", "bfloat16"] if bf16 else [])
        c = load_cfg("torch", COAM_YAML, _opts(tmp_path, cfg.DATASET.TEST_ANNOTATION_FILE,
                                               "coam", *extra))
        a = make_validate_lambda_step(c, model, ds.flip_pairs, use_lambda=False)(batch, lam)
        b = make_validate_step(c, model, ds.flip_pairs, ds.kpt_colors)(batch)
        assert a[1].dtype == b[1].dtype == (torch.bfloat16 if bf16 else torch.float32)
        for x, y in zip(a[:3], b[:3]):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_lambda_sweep_runs_one_round_and_refuses_refinement(tmp_path):
    from buctd_tpu_torch.valid import run

    ann_file, _ = _tiny_coco(tmp_path, n_imgs=2, people=2, J=J)
    opts = ["--cfg", str(COAM_YAML), "--device", "cpu", *_opts(tmp_path, ann_file, "coam"),
            "TEST.LAMBDA_SWEEP", "True", "OUTPUT_DIR", str(tmp_path / "out")]
    with pytest.raises(ValueError, match="LAMBDA_SWEEP"):
        run.main(opts + ["TEST.REFINE_ITERS", "3"])
    res = run.main(opts)
    assert len(res["ap"]) == 1 and 0.0 <= res["ap"][0] <= 1.0
    assert res["rounds"][0]["results"].endswith("_merged.json")
    assert res["rounds"][0]["crops"] == 8
    for kind in ("l0", "l1", "merged"):
        assert len(_results(res["output_dir"], kind)) >= 4
