"""buctd_tpu_torch/tools/inference.py vs the repository's tools/inference.py
(JAX), on the CPU with a tiny CoAM: both load one ``.pth`` of the same
weights (JAX through ``torch_to_flax``).

* ``run_ctd_inference`` with ``refine_iters`` 1 (the host cv2 crops, one
  forward of the image's stack, the decode) and 3 (core/refine.py's loop),
  under ``TPU.COMPUTE_DTYPE float32``: the same NaN entries (confidence under
  ``vis_thres``), and the rest within 1e-3 (image px and confidences; f32
  convs and attention summed in another order: measured 1.3e-4).
* The dtype rule: JAX's tool builds its model in ``TPU.COMPUTE_DTYPE``, which
  the yamls and the defaults set to bfloat16, whatever ``TPU.EVAL_DTYPE``
  says; so does the port.  With the yaml's bf16 both sides' confidences are
  bf16 values, off the f32 run's, and the port's positions lie within one
  heatmap pixel (4 image px at these crops) of JAX's for at least
  BF16_PX_SHARE of the joints (bf16 heatmaps computed in another order can
  move a near-tied argmax).
* ``vis_thres``: every joint under it is NaN in all three values, on both
  sides.  The CLI on a written image runs the demo pose of JAX's CLI.  An
  orbax directory raises and names ROADMAP.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from test_torch_port_config import COAM_YAML, REPO, TINY_COAM, jax_variables, load_cfg

F32 = ["TPU.COMPUTE_DTYPE", "float32"]
ATOL = 1e-3
BF16_PX_SHARE = 0.9


@pytest.fixture(scope="module")
def jax_tool():
    """The repository's tools/inference.py, imported as tools/_init_paths.py
    expects (tools/ on sys.path; BUCTD_FORCE_CPU keeps JAX on the CPU)."""
    os.environ["BUCTD_FORCE_CPU"] = "1"
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import inference
    finally:
        sys.path.remove(str(REPO / "tools"))
    # its get_model jit-compiles the model's init for a template (~15 s on
    # the CPU): build each (config, weights) pair once for the module
    build, built = inference.get_model, {}

    def get_model(config, model_path):
        key = (str(config), model_path)
        if key not in built:
            built[key] = build(config, model_path)
        return built[key]

    inference.get_model = get_model
    yield inference
    inference.get_model = build


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.models import get_model

    cfg = load_cfg("torch", opts=TINY_COAM)
    _, variables = jax_variables(load_cfg("jax", opts=TINY_COAM), seed=3)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(from_flax(variables), strict=True)
    path = tmp_path_factory.mktemp("inference") / "tiny.pth"
    torch.save(model.state_dict(), path)
    return str(path)


def _request(seed=0, poses=3):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (200, 300, 3)).astype(np.uint8)
    conds = [np.concatenate([rng.uniform(60, 180, (14, 2)), np.ones((14, 1))], -1)
             for _ in range(poses)]
    return img, conds


def _jax_run(jax_tool, opts, *args, **kw):
    """The JAX tool with its module-level cfg set to COAM_YAML + ``opts``."""
    from buctd_tpu.config import default_config, update_config

    cfg = default_config()
    update_config(cfg, types.SimpleNamespace(cfg=str(COAM_YAML), opts=list(opts)))
    jax_tool.cfg = cfg                    # the tool's functions read this global
    return jax_tool.run_ctd_inference(*args, **kw)


def _assert_close(got, want, atol=ATOL):
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isfinite(got).any()
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=0, atol=atol)


@pytest.mark.parametrize("iters", [1, 3])
def test_run_ctd_inference_matches_jax(jax_tool, weights, iters):
    from buctd_tpu_torch.tools.inference import run_ctd_inference

    img, conds = _request()
    img2, conds2 = _request(seed=1, poses=2)
    opts = TINY_COAM + F32
    want = _jax_run(jax_tool, opts, [img, img2], [conds, conds2[:1] * 3], weights, 0.5,
                    refine_iters=iters)
    got = run_ctd_inference([img, img2], [conds, conds2[:1] * 3], weights, 0.5,
                            config=load_cfg("torch", opts=opts), refine_iters=iters,
                            device="cpu")
    assert got.shape == (2, 3, 14, 3)
    assert 0 < np.isnan(got[..., 2]).mean() < 1          # vis_thres 0.5 cut some
    assert np.isnan(got).all(axis=-1)[np.isnan(got[..., 2])].all()
    _assert_close(got, want)


def test_model_runs_in_compute_dtype(jax_tool, weights):
    from buctd_tpu_torch.tools.inference import model_config, run_ctd_inference

    cfg = load_cfg("torch", opts=TINY_COAM + ["TPU.EVAL_DTYPE", "float32"])
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16"            # the yaml's
    assert model_config(cfg).TPU.EVAL_DTYPE == "bfloat16"
    img, conds = _request(seed=2)
    keep = float("-inf")
    bf16 = run_ctd_inference([img], [conds], weights, keep, config=cfg, device="cpu")
    f32 = run_ctd_inference([img], [conds], weights, keep, device="cpu",
                            config=load_cfg("torch", opts=TINY_COAM + F32))
    want = _jax_run(jax_tool, TINY_COAM, [img], [conds], weights, keep)
    conf = bf16[..., 2].astype(np.float32)
    assert np.array_equal(torch.from_numpy(conf).bfloat16().float().numpy(), conf)
    jconf = want[..., 2].astype(np.float32)
    assert np.array_equal(torch.from_numpy(jconf).bfloat16().float().numpy(), jconf)
    assert not np.allclose(bf16, f32, rtol=0, atol=1e-4)
    near = np.abs(bf16[..., :2] - want[..., :2]).max(axis=-1) <= 4.0
    assert near.mean() >= BF16_PX_SHARE, near.mean()


def test_cli_on_a_written_image(weights, tmp_path, capsys):
    """The CLI's demo pose (JAX's: the image centre + a seeded jitter) through
    ``run_ctd_inference``, which the tests above hold against JAX."""
    import cv2

    from buctd_tpu_torch.tools import inference

    img, _ = _request(seed=4)
    path = tmp_path / "person.jpg"
    cv2.imwrite(str(path), img[:, :, ::-1])
    got = inference.main(["--cfg", str(COAM_YAML), "--image", str(path), "--model", weights,
                          "--device", "cpu", *TINY_COAM, *F32])
    assert got.shape == (1, 1, 14, 3) and "[[[[" in capsys.readouterr().out
    rgb = cv2.imread(str(path))[:, :, ::-1]
    center = np.array([rgb.shape[1] / 2, rgb.shape[0] / 2])
    demo = center + np.random.RandomState(0).uniform(-60, 60, (14, 2))
    want = inference.run_ctd_inference([rgb], [[demo]], weights, 0.0, device="cpu",
                                       config=load_cfg("torch", opts=TINY_COAM + F32))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            inference.main(["--cfg", str(COAM_YAML), "--image", str(path), *TINY_COAM])
        else:
            raise RuntimeError("CUDA present: the default device is the card")


def test_orbax_directory_raises(tmp_path):
    from buctd_tpu_torch.tools.inference import get_model

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(load_cfg("torch", opts=TINY_COAM), str(tmp_path), device="cpu")
