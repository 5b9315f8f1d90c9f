"""buctd_tpu_torch models vs buctd_tpu on the same weights (CPU, tiny CoAM).

The tiny CoAM-W48 config keeps ATT_MODULES [F, T, F, F]: its branch 0 runs
32*24 = 768 position tokens (L_q*L_k >= 512^2, the flash path's threshold) and
branch 1 runs 192.  Heatmaps (values up to ~20) agree to 1e-4 absolute: f32
convs and attention summed in another order differ by ~2e-5 here.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_config import TINY_COAM, jax_variables, load_cfg, port_model


def _input(cfg, n=2, seed=0):
    img_w, img_h = cfg.MODEL.IMAGE_SIZE
    rng = np.random.RandomState(seed)
    return rng.randn(n, img_h, img_w, 6).astype(np.float32)


def _jax_forward(model, variables, x):
    return np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x)))                                    # NHWC


@pytest.fixture(scope="module")
def tiny():
    cfg = load_cfg("jax", opts=TINY_COAM)
    model, variables = jax_variables(cfg, seed=1)
    x = _input(cfg)
    return variables, x, _jax_forward(model, variables, x)


@pytest.mark.parametrize("engine", ["auto", "flash"])
def test_tiny_coam_forward_matches_jax(tiny, engine):
    variables, x, want = tiny
    port = port_model(load_cfg("torch", opts=TINY_COAM + ["TPU.ATTENTION_ENGINE", engine]),
                      variables)
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())  # NCHW
    assert got.shape == (2, 14, 32, 24)
    assert np.abs(want).max() > 0.1              # peaked weights: O(1) maps
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-4, rtol=0)


def test_state_dict_round_trips_through_jax_converter():
    """torch_to_flax(port.state_dict(), template, strict=True) rebuilds the JAX
    variables exactly: every key name and layout matches both ways."""
    from buctd_tpu.convert import torch_to_flax

    cfg = load_cfg("jax", opts=TINY_COAM)
    _, template = jax_variables(cfg, seed=0)
    _, variables = jax_variables(cfg, seed=2)
    port = port_model(load_cfg("torch", opts=TINY_COAM), variables)
    back = torch_to_flax(port.state_dict(), template, strict=True)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_back) == len(flat_want) > 100
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_want[path],
                                      err_msg=jax.tree_util.keystr(path))


def test_selfatt_modules_are_built_but_not_called():
    """SELFATT_MODULES builds the self-attention twin (checkpoint layout) that
    the reference forward never calls, in both packages."""
    opts = TINY_COAM + ["MODEL.ATT_MODULES", "[False, True, False, False]",
                        "MODEL.SELFATT_MODULES", "[True, False, False, False]"]
    jcfg, tcfg = load_cfg("jax", opts=opts), load_cfg("torch", opts=opts)
    model, variables = jax_variables(jcfg, seed=3)
    port = port_model(tcfg, variables)                 # strict load: same keys
    assert any(k.startswith("stage1_att.") for k in port.state_dict())
    x = _input(jcfg, n=1, seed=4)
    want = _jax_forward(model, variables, x)
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-4, rtol=0)


def test_unported_models_and_bf16_raise():
    from buctd_tpu_torch.models import compute_dtype, get_model
    from buctd_tpu_torch.serving import PoseEstimator

    # pose_resnet is ported (tests/test_torch_port_resnet.py): it builds; an
    # unknown name, and a lambda head on a model without one, raise
    cfg = load_cfg("torch", opts=TINY_COAM + ["MODEL.NAME", "pose_resnet",
                                              "MODEL.EXTRA.NUM_LAYERS", "18"])
    assert type(get_model(cfg, device="cpu")).__name__ == "PoseResNet"
    with pytest.raises(ValueError, match="lambda head"):
        get_model(cfg, device="cpu", lambda_head=True)
    with pytest.raises(KeyError, match="unknown MODEL.NAME"):
        get_model(load_cfg("torch", opts=TINY_COAM + ["MODEL.NAME", "pose_mobilenet"]))
    cfg = load_cfg("torch", opts=TINY_COAM + ["TPU.EVAL_DTYPE", "bfloat16"])
    assert compute_dtype(cfg, "EVAL_DTYPE") == torch.bfloat16
    # bf16 serving is ported (tests/test_torch_port_eval_bf16.py): the
    # estimator builds, its parameters f32 under the bf16 autocast
    est = PoseEstimator(cfg, device="cpu")
    assert est.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in est.model.parameters())
    with pytest.raises(ValueError, match="EVAL_DTYPE"):
        compute_dtype(load_cfg("torch", opts=TINY_COAM + ["TPU.EVAL_DTYPE", "float16"]),
                      "EVAL_DTYPE")
    if not torch.cuda.is_available():   # the card is the default device
        with pytest.raises(RuntimeError, match="CUDA"):
            get_model(load_cfg("torch", opts=TINY_COAM))
    # training mode is ported: dropout acts, the eval forward is unchanged
    model = get_model(load_cfg("torch", opts=TINY_COAM), device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 6, 128, 96).astype(np.float32))
    with torch.no_grad():
        want = model(x)
        torch.manual_seed(0)
        got = model.train()(x)
    assert got.shape == want.shape and torch.isfinite(got).all()
