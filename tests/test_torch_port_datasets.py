"""buctd_tpu_torch's OCHuman and DeepLabCut animal datasets (ochuman, fish,
multimouse, marmosets) vs buctd_tpu's, on tiny synthetic annotation files
in each set's joint count: the test-time db, the flip pairs, the OKS sigmas
and joint weights, and ``evaluate`` on the same predictions (the results
json equal, every AP stat within 1e-6).  OCHuman is COCO's class; the
animal sets score with a flat 0.1 sigma and NMS with ``joints_weight / 10``.
"""

import json

import numpy as np
import pytest

from test_data_pipeline import _tiny_coco
from test_torch_port_config import COAM_YAML, load_cfg

SETS = {"ochuman": 17, "fish": 7, "multimouse": 12, "marmosets": 15}


def _opts(tmp_path, ann_file, name):
    return ["DATASET.DATASET", name, "MODEL.NUM_JOINTS", str(SETS[name]),
            "DATASET.TEST_IMAGE_DIR", str(tmp_path), "DATASET.TEST_ANNOTATION_FILE", ann_file,
            "TEST.OKS_THRE", "0.5", "TEST.IN_VIS_THRE", "0.2"]


def _assert_same(a, b, key=""):
    """Equal values, recursing into dicts and lists of arrays."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), key
        for k in a:
            _assert_same(a[k], b[k], f"{key}.{k}")
    elif isinstance(a, (np.ndarray, list, tuple)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=key)
    else:
        assert a == b, key


def _preds(ds, gt, joints, seed):
    """Each db record's nearest GT pose plus noise, random confidences."""
    rng = np.random.RandomState(seed)
    kps = {}
    for a in gt["annotations"]:
        kps.setdefault(a["image_id"], []).append(
            np.array(a["keypoints"], np.float64).reshape(-1, 3))
    preds, boxes, paths = [], [], []
    for rec in ds.db:
        image_id = next(i["id"] for i in gt["images"] if rec["image"].endswith(i["file_name"]))
        near = min(kps[image_id], key=lambda k: np.abs(k[:, :2].mean(0) - rec["center"]).sum())
        p = near.copy()
        p[:, :2] += rng.randn(joints, 2) * rng.uniform(2, 30)
        p[:, 2] = rng.uniform(0, 1, joints)
        preds.append(p)
        c, s = rec["center"], rec["scale"]
        boxes.append([c[0], c[1], s[0], s[1], np.prod(np.asarray(s) * 200),
                      rec.get("score", 1), rec.get("annotation_id", 0)])
        paths.append(rec["image"])
    return np.array(preds), np.array(boxes), paths


@pytest.mark.parametrize("name", list(SETS))
def test_dataset_matches_jax(tmp_path, name):
    from buctd_tpu.data import get_dataset as jax_dataset
    from buctd_tpu_torch.data import datasets
    from buctd_tpu_torch.data.datasets import get_dataset

    joints = SETS[name]
    ann_file, gt = _tiny_coco(tmp_path, n_imgs=3, people=2, J=joints)
    opts = _opts(tmp_path, ann_file, name)
    cfg, jcfg = load_cfg("torch", COAM_YAML, opts), load_cfg("jax", COAM_YAML, opts)
    ours, theirs = get_dataset(cfg, is_train=False), jax_dataset(jcfg, is_train=False)
    assert type(ours).__name__ == type(theirs).__name__
    assert isinstance(ours, getattr(datasets, type(theirs).__name__))
    assert len(ours.db) == len(theirs.db) == 6
    for a, b in zip(ours.db, theirs.db):
        _assert_same(a, b)
    assert ours.flip_pairs == theirs.flip_pairs
    np.testing.assert_array_equal(ours.oks_sigmas, theirs.oks_sigmas)
    np.testing.assert_array_equal(ours.joints_weight, theirs.joints_weight)
    np.testing.assert_array_equal(ours.kpt_colors, theirs.kpt_colors)
    assert (ours.upper_body_ids, ours.lower_body_ids) == (theirs.upper_body_ids,
                                                          theirs.lower_body_ids)
    if name != "ochuman":
        np.testing.assert_array_equal(ours.oks_sigmas, np.full(joints, 0.1))
        # NMS and the merge take joints_weight / 10 (f32), not oks_sigmas
        np.testing.assert_array_equal(ours._sigmas(), np.ones(joints, np.float32) / 10.0)

    preds, boxes, paths = _preds(ours, gt, joints, seed=SETS[name])
    got_nv, got_ap = ours.evaluate(cfg, preds, str(tmp_path / "ours"), boxes, paths, 2)
    want_nv, want_ap = theirs.evaluate(jcfg, preds, str(tmp_path / "jax"), boxes, paths, 2)
    res = "results/keypoints_test_results_epoch2.json"
    got_json = json.loads((tmp_path / "ours" / res).read_text())
    assert got_json == json.loads((tmp_path / "jax" / res).read_text())
    assert len(got_json) == len(preds) and 0.0 < got_ap < 1.0
    assert list(got_nv) == list(want_nv)
    np.testing.assert_allclose(list(got_nv.values()), list(want_nv.values()), atol=1e-6)
    assert abs(got_ap - want_ap) <= 1e-6


def test_registry_has_every_jax_dataset():
    from buctd_tpu.data.datasets import _REGISTRY as JAX_REGISTRY
    from buctd_tpu_torch.data.datasets import _REGISTRY

    assert sorted(_REGISTRY) == sorted(JAX_REGISTRY)
    assert {k: v.__name__ for k, v in _REGISTRY.items()} == {
        k: v.__name__ for k, v in JAX_REGISTRY.items()}
