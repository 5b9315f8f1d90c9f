"""buctd_tpu_torch's serving export (``torch.export`` artifacts) vs the live
estimator and vs buctd_tpu's StableHLO artifact, on the CPU (tiny CoAM with
the flash engine, one round, one artifact for the module).

- The artifact equals the live port estimator bit for bit: a loaded program
  runs the same ATen ops and the same flash operator on the same inputs.
- It matches JAX's ExportedPoseEstimator, exported from JAX's estimator of
  the same weights, to 1e-3 px and 1e-3 in confidence, with
  test_torch_port_serving.py's margin check on the port's heatmaps.
- ``torch.ops.buctd.flash_fwd`` on CPU tensors is the plain version: held
  against JAX's flash attention in interpret mode at 2e-5, as
  test_torch_port_flash.py holds the wrapper; a program holds it as one node.
- params.npz is the port's state_dict of ``from_flax``'s weights, exactly.
- The contract's refusals: no containing bucket, a batched-only artifact,
  the format guard, another device, the serve tool's refused flags.
- ``--checkpoint`` of both tools takes an orbax directory of JAX's
  save_params (the export's params.npz are ``from_flax`` of the saved tree;
  the serve tool answers as from a ``.pth`` of the same state_dict), and a
  save_checkpoint train-state directory raises ValueError.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_config import COAM_YAML, TINY_COAM, jax_variables, load_cfg
from test_torch_port_serving import MARGIN, _Recorder
from test_torch_port_serving_budget import _SeededModel

ATOL, RTOL = 1e-3, 1e-4
J = 14
OPTS = TINY_COAM + ["TPU.ATTENTION_ENGINE", "flash"]
SHAPES = [(256, 256, 4), (2, 256, 256, 4)]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The port's artifact of SHAPES, the live port estimator it came from,
    JAX's artifact of the single shape from JAX's estimator of the same
    weights, and those weights."""
    import buctd_tpu.models
    from buctd_tpu.serving import PoseEstimator as JaxEstimator
    from buctd_tpu.serving_export import export_estimator as jax_export
    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.serving import PoseEstimator

    jcfg, tcfg = load_cfg("jax", opts=OPTS), load_cfg("torch", opts=OPTS)
    model, variables = jax_variables(jcfg, seed=5)
    colors = np.linspace(0, 255, J * 3).reshape(-1, 3)
    est = PoseEstimator(tcfg, refine_iters=1, colors=colors, device="cpu")
    est.model.load_state_dict(from_flax(variables), strict=True)
    est.recorder = _Recorder(est.model)
    out = str(tmp_path_factory.mktemp("port_artifact"))
    manifest = est.export(SHAPES, out)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(buctd_tpu.models, "get_model", lambda cfg, **_: _SeededModel(model, variables))
        jest = JaxEstimator(jcfg, refine_iters=1, colors=colors)
    jest.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    jax_out = str(tmp_path_factory.mktemp("jax_artifact"))
    jax_export(jest, SHAPES[:1], jax_out, platforms=("cpu",))
    return est, out, manifest, jax_out, variables


@pytest.fixture(scope="module")
def art(artifact):
    """The port's artifact loaded once for the module (each program loads at
    its first call)."""
    return loaded(artifact[1])


def request(seed, h=200, w=220, poses=3):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 255, (h, w, 3)).astype(np.uint8),
            rng.uniform(30, 180, (poses, J, 2)).astype(np.float32))


def loaded(path, **kw):
    from buctd_tpu_torch.serving_export import ExportedPoseEstimator

    return ExportedPoseEstimator(path, device="cpu", **kw)


def test_manifest_and_files(artifact):
    est, out, manifest, _, _ = artifact
    assert manifest["format_version"] == 1
    assert manifest["programs"] == [[256, 256, 4], [2, 256, 256, 4]]
    assert (manifest["model_name"], manifest["num_joints"], manifest["refine_iters"],
            manifest["eval_dtype"], manifest["platforms"]) == (
        "pose_hrnet_coam", J, 1, "float32", ["cpu"])
    assert manifest["torch_version"] == torch.__version__
    assert sorted(os.listdir(out)) == ["manifest.json", "params.npz",
                                       "prog_256x256x4.pt2", "prog_2x256x256x4.pt2"]
    # the weights travel as arguments: a program file holds none of them
    weights = os.path.getsize(os.path.join(out, "params.npz"))
    assert os.path.getsize(os.path.join(out, "prog_256x256x4.pt2")) < weights


def test_params_npz_are_from_flax_weights(artifact):
    from buctd_tpu_torch.convert import from_flax

    est, out, _, _, variables = artifact
    want = from_flax(variables)
    with np.load(os.path.join(out, "params.npz")) as z:
        assert z.files == list(est.model.state_dict())
        for k in z.files:
            np.testing.assert_array_equal(z[k], np.asarray(want[k]), err_msg=k)


def test_loader_imports_no_model_or_config_code():
    """What ExportedPoseEstimator imports, at module level and in its
    functions: the bucket contract, the port's ops and graphs, no model,
    config, data or refinement code; and what those modules import at
    module level: no module of the port but the ops."""
    import ast
    from pathlib import Path

    pkg = Path(__file__).resolve().parents[1] / "buctd_tpu_torch"

    def imports(name, nodes):
        tree = ast.parse((pkg / name).read_text())
        return sorted(n.module for n in (ast.walk(tree) if nodes == "all" else tree.body)
                      if isinstance(n, ast.ImportFrom) and n.level)

    assert imports("serving_export.py", "all") == ["buckets", "graphs", "ops"]
    assert imports("buckets.py", "top") == imports("graphs.py", "top") == []


def test_artifact_equals_live_estimator(artifact, art):
    est = artifact[0]
    img, conds = request(0)   # 3 poses: the 4-pose bucket on both
    got, want = art.predict(img, conds, -np.inf), est.predict(img, conds, -np.inf)
    assert got.shape == want.shape == (3, J, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    images = [img, request(1, 180, 240)[0]]
    poses = [conds, request(1, poses=3)[1]]
    for got, want in zip(art.predict_batch(images, poses, -np.inf),
                         est.predict_batch(images, poses, -np.inf)):
        np.testing.assert_array_equal(got, want)
    # one (J, 2) pose: the artifact pads it into its 4-pose program, the live
    # estimator admits the 1-pose bucket; another batch for the convs sums in
    # another order: a few f32 steps of coordinates up to 256 px
    got, want = art.predict(img, conds[0], -np.inf), est.predict(img, conds[0], -np.inf)
    assert got.shape == (1, J, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_artifact_matches_jax_artifact(artifact, art):
    from buctd_tpu.serving_export import ExportedPoseEstimator as JaxExported

    est, _, _, jax_out, _ = artifact
    img, conds = request(2)
    got = art.predict(img, conds, -np.inf)
    want = JaxExported(jax_out).predict(img, conds, -np.inf)
    assert got.shape == want.shape == (3, J, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    est.recorder.maps.clear()
    est.predict(img, conds, -np.inf)   # the same forward, recorded for the margins
    assert est.recorder.min_margin() > MARGIN


def test_no_containing_bucket_raises(art):
    with pytest.raises(RuntimeError, match="no exported program"):
        art.predict(*request(3, 400, 400, 2))
    with pytest.raises(RuntimeError, match="no exported program"):
        art.predict(*request(3, 100, 100, 9))   # more poses than the p-bucket


def test_batched_only_artifact_serves_one_image(artifact, art, tmp_path):
    """An artifact of only a batched program serves a lone image through
    predict_batch (pad rows); predict raises."""
    est, out, manifest, _, _ = artifact
    shared = art
    for name in ("params.npz", "prog_2x256x256x4.pt2"):
        os.symlink(os.path.join(out, name), tmp_path / name)
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump({**manifest, "programs": [[2, 256, 256, 4]]}, f)
    art = loaded(str(tmp_path))
    art._progs[(2, 256, 256, 4)] = shared._load((2, 256, 256, 4))   # the same file, loaded once
    img, conds = request(4, 150, 160, 3)
    with pytest.raises(RuntimeError, match="no exported program"):
        art.predict(img, conds)
    got = art.predict_batch([img], [conds], -np.inf)
    assert got[0].shape == (3, J, 3)
    # the live estimator's batched bucket on the same two rows (the pad row
    # repeats the image)
    want = est.predict_batch([img, img], [conds, conds], -np.inf)[0]
    np.testing.assert_array_equal(got[0], want)


def test_format_and_device_guards(artifact, tmp_path, monkeypatch):
    _, out, manifest, _, _ = artifact
    for name in ("params.npz", "prog_256x256x4.pt2"):
        os.symlink(os.path.join(out, name), tmp_path / name)
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump({**manifest, "format_version": 99}, f)
    with pytest.raises(ValueError, match="format 99"):
        loaded(str(tmp_path))
    from buctd_tpu_torch.serving_export import ExportedPoseEstimator
    with pytest.raises(ValueError, match="exported for"):   # a CPU artifact on the card
        ExportedPoseEstimator(out, device="cuda")
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump({**manifest, "platforms": ["cuda"]}, f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExportedPoseEstimator(str(tmp_path))   # device="cuda" by default


def test_flash_op_is_the_plain_version_on_the_cpu(artifact, art, monkeypatch):
    from buctd_tpu.ops.flash_attention import flash_attention as jax_flash
    from buctd_tpu_torch.models import attention

    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(2, 300, 48).astype(np.float32) for _ in range(3))
    for kvres in (False, True):   # CPU tensors take the plain version either way
        got, lse = torch.ops.buctd.flash_fwd(*map(torch.from_numpy, (q, k, v)), 0.125, 0.0, 0,
                                             kvres)
        want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0, 0.125, 0.0, True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
        assert lse.shape == (2, 300)
    # the program holds the operator once for each flash call of a forward
    calls = []
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, f=attention.flash_attention: calls.append(1) or f(*a))
    artifact[0].predict(*request(5))
    prog = art._load((256, 256, 4))
    targets = [str(n.target) for m in prog.modules() for n in m.graph.nodes]
    assert len(calls) >= 2 and targets.count("buctd.flash_fwd.default") == len(calls)


def test_serve_tool_over_a_manifest(artifact, art, tmp_path):
    """``tools.serve --exported`` on two requests equals the artifact's own
    predict_batch; the live tool on the same requests gives their shapes."""
    import cv2

    from buctd_tpu_torch.tools import serve

    _, out, _, _, _ = artifact
    entries, images, poses = [], [], []
    for i, (h, w, p) in enumerate(((200, 220, 3), (180, 240, 2))):
        img, conds = request(10 + i, h, w, p)
        cv2.imwrite(str(tmp_path / f"{i}.png"), img[:, :, ::-1])   # RGB -> BGR
        entries.append({"image": str(tmp_path / f"{i}.png"), "poses": conds.tolist()})
        images.append(img)
        poses.append(conds)
    with open(tmp_path / "requests.json", "w") as f:
        json.dump(entries, f)
    common = ["--manifest", str(tmp_path / "requests.json"), "--device", "cpu",
              "--vis-thres=-1e9"]
    served = serve.main(["--exported", out, "--out", str(tmp_path / "a.json"), *common])
    for entry, want in zip(served, art.predict_batch(images, poses, -1e9)):
        np.testing.assert_array_equal(np.asarray(entry["predictions"], np.float32), want)
    with open(tmp_path / "a.json") as f:
        assert json.load(f) == served
    live = serve.main(["--cfg", str(COAM_YAML), "--out", str(tmp_path / "b.json"),
                       "--precompile", "2,256,256,4", *common, *TINY_COAM])
    assert [np.asarray(e["predictions"]).shape for e in live] == [(3, J, 3), (2, J, 3)]
    # --data-parallel serves over the local devices (here the CPU alone)
    mesh = serve.main(["--cfg", str(COAM_YAML), "--out", str(tmp_path / "c.json"),
                       "--data-parallel", *common, *TINY_COAM])
    assert [np.asarray(e["predictions"]).shape for e in mesh] == [(3, J, 3), (2, J, 3)]


def test_export_tool_selftest_on_the_artifact(artifact, art):
    """``tools.export``'s selftest on the module's artifact: a random request
    of each program's bucket, every joint compared with the live estimator."""
    from buctd_tpu_torch.tools import export

    for key in ((256, 256, 4), (2, 256, 256, 4)):
        assert export.selftest(artifact[0], art, key) == 0.0


@pytest.fixture(scope="module")
def orbax_dirs(artifact, tmp_path_factory):
    """JAX's save_params of the module's weights, a save_checkpoint train
    state of them, and a .pth of their from_flax state_dict."""
    from test_torch_port_orbax import write_params_dir, write_train_state_dir

    from buctd_tpu_torch.convert import from_flax

    variables = artifact[4]
    root = tmp_path_factory.mktemp("orbax")
    jcfg = load_cfg("jax", opts=OPTS)
    model, _ = jax_variables(jcfg, seed=5)
    torch.save(from_flax(variables), root / "weights.pth")
    return {"PARAMS": write_params_dir(root / "params", variables),
            "TRAIN_STATE": write_train_state_dir(root, jcfg, model, variables),
            "PTH": str(root / "weights.pth")}


@pytest.mark.parametrize("argv,error,match", [
    (["--exported", "x", "--refine-iters", "3"], SystemExit, "--refine-iters apply to a live"),
    (["--exported", "x", "--data-parallel"], SystemExit, "--data-parallel apply to a live"),
    (["--cfg", str(COAM_YAML), "--checkpoint", "TRAIN_STATE", *OPTS], ValueError,
     "opt_state"),
    ([], SystemExit, "one of --cfg or --exported is required"),
])
def test_serve_tool_refusals(tmp_path, orbax_dirs, argv, error, match):
    from buctd_tpu_torch.tools import serve

    argv = [orbax_dirs.get(a, a) for a in argv]
    (tmp_path / "m.json").write_text("[]")
    with pytest.raises(error, match=match):
        serve.main(["--manifest", str(tmp_path / "m.json"), "--out", str(tmp_path / "o.json"),
                    "--device", "cpu", *argv])


@pytest.mark.parametrize("argv,error,match", [
    (["--checkpoint", "TRAIN_STATE"], ValueError, "opt_state"),
])
def test_export_tool_refusals(tmp_path, orbax_dirs, argv, error, match):
    from buctd_tpu_torch.tools import export

    argv = [orbax_dirs.get(a, a) for a in argv]
    with pytest.raises(error, match=match):
        export.main(["--cfg", str(COAM_YAML), "--out", str(tmp_path / "o"), "--shape",
                     "256x256x4", "--device", "cpu", *argv, *OPTS])


def test_tools_load_an_orbax_checkpoint(artifact, orbax_dirs, tmp_path):
    """``tools.export --checkpoint DIR`` writes the module artifact's
    weights and passes its selftest; ``tools.serve --checkpoint DIR``
    answers as with a .pth of the same state_dict."""
    import cv2

    from buctd_tpu_torch.tools import export, serve

    out = tmp_path / "art"
    export.main(["--cfg", str(COAM_YAML), "--checkpoint", orbax_dirs["PARAMS"], "--out",
                 str(out), "--shape", "256x256x4", "--device", "cpu", "--selftest", *OPTS])
    with np.load(out / "params.npz") as z, np.load(os.path.join(artifact[1], "params.npz")) as w:
        assert z.files == w.files
        for k in z.files:
            np.testing.assert_array_equal(z[k], w[k], err_msg=k)
    img, conds = request(21)
    cv2.imwrite(str(tmp_path / "0.png"), img[:, :, ::-1])
    (tmp_path / "m.json").write_text(json.dumps([{"image": str(tmp_path / "0.png"),
                                                  "poses": conds.tolist()}]))
    answers = [serve.main(["--cfg", str(COAM_YAML), "--checkpoint", orbax_dirs[key],
                           "--manifest", str(tmp_path / "m.json"), "--out",
                           str(tmp_path / f"{key}.json"), "--device", "cpu",
                           "--vis-thres=-1e9", *OPTS])
               for key in ("PARAMS", "PTH")]
    got, want = (np.asarray(a[0]["predictions"], np.float32) for a in answers)
    assert got.shape == (3, J, 3)
    np.testing.assert_array_equal(got, want)
