"""Sharded evaluation and ``mesh=`` serving in buctd_tpu_torch, on the CPU.

* ``validate`` and ``validate_lambda_quantitative`` in 2 processes over
  gloo (tests/torch_dist_children.py) on a tiny CrowdPose-format set of 5
  crops (odd: process 1's shard ends in a padding row) with annotation ids
  2^31 + 5 and 2^40 + 3 among them: what ``dataset.evaluate`` receives on
  each process equals the one-process run's (preds within 1e-6, boxes and
  ids exact, image paths rebuilt from the gathered db indices; the lambda
  sweep's rows sorted by (id, lambda), as tests/disthelp.py::lambda_canon,
  since its order interleaves batches and lambdas), and so does the AP;
  process 1 evaluates into ``proc1/``.
* The logged loss and accuracy of ``validate``, the lambda sweep and
  ``validate_lambda`` are the global batches': on 4 crops, where the
  one-process batch of 4 and the two processes' 2 + 2 rows are the same
  global batch, they equal the one-process values (1e-6).
* ``valid.run`` with ``--coordinator/--num-processes/--process-id`` on
  ``--device cpu``, two refinement rounds: each process feeds round 1 from
  its own round-0 results, and every results file equals the one-process
  run's.
* ``PoseEstimator(mesh=make_mesh(devices=[cpu, cpu]))``: count buckets
  (2, 4, 8, 16), ``precompile`` bucketing against them, ``predict_batch``
  and ``predict`` equal to the one-device estimator's, and its export (the
  per-device program) serving the same; ``tools.serve --data-parallel``
  runs, and is refused beside ``--exported``.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_children as tdc
from test_data_pipeline import _tiny_coco
from test_torch_port_config import COAM_YAML, TINY_COAM, load_cfg

J = 14
BIG_IDS = (2 ** 31 + 5, 2 ** 40 + 3)


def _weights(seed=0):
    from buctd_tpu_torch.models import get_model

    torch.manual_seed(seed)
    model = get_model(load_cfg("torch", opts=TINY_COAM), device="cpu")
    for p in model.parameters():                     # O(1) heatmaps with clear peaks
        if p.dim() > 1:
            torch.nn.init.normal_(p, 0.0, float(p[0].numel()) ** -0.5)
    return model.state_dict()


def _eval_set(tmp_path, crops: int):
    """A CrowdPose-format set of ``crops`` annotations over 3 images, with
    the large annotation ids."""
    ann_file, gt = _tiny_coco(tmp_path, n_imgs=3, people=2, J=J)
    gt["annotations"] = gt["annotations"][:crops]
    for ann, big in zip(gt["annotations"][1::2], BIG_IDS):
        ann["id"] = big
    Path(ann_file).write_text(json.dumps(gt))
    return ann_file


def _job(tmp_path, kind, crops, out="out"):
    ann_file = _eval_set(tmp_path, crops)
    opts = TINY_COAM + ["DATASET.TEST_IMAGE_DIR", str(tmp_path),
                        "DATASET.TEST_ANNOTATION_FILE", ann_file, "WORKERS", "1",
                        "PRINT_FREQ", "1"]
    return {"yaml": COAM_YAML, "opts": opts, "state_dict": _weights(), "kind": kind,
            "batch": 4, "out": str(tmp_path / out)}


def _canon(seen):
    """The lambda sweep's rows sorted by (annotation id, lambda)."""
    order = np.lexsort((seen["boxes"][:, 7], seen["boxes"][:, 6]))
    return {"preds": seen["preds"][order], "boxes": seen["boxes"][order],
            "paths": [seen["paths"][i] for i in order]}


@pytest.mark.parametrize("kind", ["validate", "lambda"])
def test_sharded_evaluation_hands_evaluate_the_one_process_rows(tmp_path, kind):
    job = _job(tmp_path, kind, crops=5)
    torch.save(job, tmp_path / "validate_job.pt")
    outs = tdc.spawn("validate", tmp_path)
    one = tdc.validate_job(dict(job, out=str(tmp_path / "one")))
    canon = _canon if kind == "lambda" else (lambda seen: seen)
    want = canon(one)
    assert len(want["preds"]) == 5 * (2 if kind == "lambda" else 1)
    ids = set(want["boxes"][:, 6].astype(np.int64).tolist())
    assert set(BIG_IDS) <= ids
    for rank, out in enumerate(outs):
        got = canon(out)
        np.testing.assert_allclose(got["preds"], want["preds"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["boxes"], want["boxes"])
        assert got["boxes"][:, 6].astype(np.int64).tolist() == \
            want["boxes"][:, 6].astype(np.int64).tolist()
        assert got["paths"] == want["paths"]
        assert out["ap"] == pytest.approx(one["ap"], abs=1e-9)
        assert out["output_dir"] == str(tmp_path / "out" / (f"proc{rank}" if rank else ""))
    suffix = "_merged" if kind == "lambda" else ""
    for root in (tmp_path / "out", tmp_path / "out" / "proc1"):
        assert (root / "results" / f"keypoints_test_results_epoch-1{suffix}.json").exists()


@pytest.mark.parametrize("kind", ["validate", "lambda", "qualitative"])
def test_logged_loss_and_accuracy_are_the_global_batches(tmp_path, kind):
    job = _job(tmp_path, kind, crops=4)
    torch.save(job, tmp_path / "validate_job.pt")
    outs = tdc.spawn("validate", tmp_path)
    one = tdc.validate_job(dict(job, out=str(tmp_path / "one")))
    for out in outs:
        if kind == "qualitative":
            assert list(out["sweep"]) == list(one["sweep"])
            for lam, (loss, acc) in one["sweep"].items():
                assert out["sweep"][lam] == pytest.approx((loss, acc), rel=1e-6, abs=1e-6)
        else:
            assert (out["loss"], out["acc"]) == pytest.approx((one["loss"], one["acc"]),
                                                             rel=1e-6, abs=1e-6)


VALID = ("import sys; sys.path.insert(0, 'tests'); import torch_cpu_threads; "
         "from buctd_tpu_torch.valid import run; r = run.main(sys.argv[1:]); "
         "print('RESULT', r['ap'])")


def test_valid_run_in_two_processes_refines_from_its_own_results(tmp_path):
    from buctd_tpu_torch.valid import run

    ann_file = _eval_set(tmp_path, crops=5)
    model = tmp_path / "model.pth"
    torch.save(_weights(), model)

    def args(out):
        return ["--cfg", str(COAM_YAML), "--device", "cpu", *TINY_COAM,
                "DATASET.TEST_IMAGE_DIR", str(tmp_path), "DATASET.TEST_ANNOTATION_FILE",
                ann_file, "TEST.BATCH_SIZE_PER_GPU", "2", "WORKERS", "1",
                "TEST.REFINE_ITERS", "2", "TEST.MODEL_FILE", str(model),
                "OUTPUT_DIR", str(tmp_path / out)]

    two = args("two")

    def argv(rank, port):
        return ["-c", VALID, *two[:4], "--coordinator", f"localhost:{port}",
                "--num-processes", "2", "--process-id", str(rank), *two[4:]]

    lines = [line for out in tdc.spawn_command(argv) for line in out.splitlines()
             if line.startswith("RESULT")]
    one = run.main(args("one"))
    assert lines == [f"RESULT {one['ap']}"] * 2
    root = one["output_dir"]
    stem = root.relative_to(tmp_path / "one")
    for it in range(2):
        name = f"results/keypoints_test_results_epoch{it}.json"
        want = json.loads((root / name).read_text())
        assert len(want) == 5
        for got_dir in (tmp_path / "two" / stem, tmp_path / "two" / stem / "proc1"):
            got = json.loads((got_dir / name).read_text())
            assert [(g["image_id"], g["annotation_id"]) for g in got] == \
                [(w["image_id"], w["annotation_id"]) for w in want]
            for g, w in zip(got, want):
                np.testing.assert_allclose(g["keypoints"], w["keypoints"], rtol=0, atol=1e-4)
                assert g["center"] == pytest.approx(w["center"], abs=1e-4)


def _request(seed, h=200, w=220, poses=3):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 255, (h, w, 3)).astype(np.uint8),
            rng.uniform(30, 180, (poses, J, 2)).astype(np.float32))


def test_pose_estimator_over_a_mesh_serves_what_one_device_serves(tmp_path):
    from buctd_tpu_torch.parallel import make_mesh
    from buctd_tpu_torch.serving import PoseEstimator
    from buctd_tpu_torch.serving_export import ExportedPoseEstimator

    ckpt = tmp_path / "model.pth"
    torch.save(_weights(), ckpt)
    cfg = load_cfg("torch", opts=TINY_COAM)
    single = PoseEstimator(cfg, checkpoint=str(ckpt), refine_iters=2, device="cpu")
    mesh = make_mesh(devices=["cpu", "cpu"])
    est = PoseEstimator(cfg, checkpoint=str(ckpt), refine_iters=2, mesh=mesh,
                        precompile=[(3, 200, 220, 3)])
    assert mesh.size == 2 and est.count_buckets == (2, 4, 8, 16)
    assert single.count_buckets == (2, 4, 8)
    assert est._compiled == {(4, 256, 256, 4)}         # 3 images -> the 4-row bucket
    assert est.device == torch.device("cpu") and len(est._replicas) == 2
    assert est._replicas[1][0] is not est.refine
    reqs = [_request(s) for s in range(5)] + [_request(9, 300, 400, 2)]
    images, poses = [r[0] for r in reqs], [r[1] for r in reqs]
    got = est.predict_batch(images, poses, -1e9)
    want = single.predict_batch(images, poses, -1e9)
    assert [g.shape for g in got] == [w.shape for w in want] == [(3, J, 3)] * 5 + [(2, J, 3)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(est.predict(*reqs[0], -1e9), single.predict(*reqs[0], -1e9))
    # the mesh estimator exports the per-device program, which serves the same
    manifest = est.export([(2, 200, 220, 3)], str(tmp_path / "art"))
    assert manifest["programs"] == [[2, 256, 256, 4]]
    art = ExportedPoseEstimator(str(tmp_path / "art"), device="cpu")
    for g, w in zip(art.predict_batch(images[:2], poses[:2], -1e9), want[:2]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_serve_tool_data_parallel_runs(tmp_path):
    import cv2

    from buctd_tpu_torch.tools import serve

    entries = []
    for i in range(3):
        img, conds = _request(20 + i)
        cv2.imwrite(str(tmp_path / f"{i}.png"), img[:, :, ::-1])
        entries.append({"image": str(tmp_path / f"{i}.png"), "poses": conds.tolist()})
    (tmp_path / "m.json").write_text(json.dumps(entries))
    common = ["--manifest", str(tmp_path / "m.json"), "--device", "cpu"]
    served = serve.main(["--cfg", str(COAM_YAML), "--data-parallel", "--out",
                         str(tmp_path / "o.json"), *common, *TINY_COAM])
    assert [np.asarray(e["predictions"]).shape for e in served] == [(3, J, 3)] * 3
    with pytest.raises(SystemExit, match="--data-parallel apply to a live"):
        serve.main(["--exported", "x", "--data-parallel", "--out", str(tmp_path / "p.json"),
                    *common])
