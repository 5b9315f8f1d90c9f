"""buctd_tpu_torch pose_hrnet / BUCTD-preNet and models/fuse.py vs buctd_tpu
(CPU, a tiny preNet-W48: one module and one block per stage, 8/16/32/64
channels, 96x64 inputs).

Weights are N(0, 1/fan_in) with BN statistics away from the identity
(test_torch_port_config.jax_variables), so a folding fault cannot hide behind
identity BNs.  Tolerances: heatmaps 1e-4 absolute (f32 convs summed in
another order; values O(1)); the fused stem's weights bit-equal to JAX's (the
same float64 fold cast to f32); fused vs unfused forward 1e-5 of the
heatmaps' max (the fold reassociates f32 sums); PoseEstimator predictions
1e-3 px and confidences 1e-3 (as tests/test_torch_port_serving.py).
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_config import REPO, TINY_COAM, load_cfg

PRENET_YAML = REPO / "experiments" / "crowdpose" / "buctd" / "prenet_w48_384x288.yaml"
TINY = TINY_COAM + ["MODEL.IMAGE_SIZE", "[64, 96]", "MODEL.HEATMAP_SIZE", "[16, 24]"]
PLAIN = TINY + ["MODEL.EXTRA.USE_PRE_NET", "False"]


def _variables(cfg, seed: int, lam: bool = False):
    """JAX PoseHRNet + variables (lambda head included when ``lam``), leaves
    from a numpy seed as test_torch_port_config.jax_variables draws them."""
    from buctd_tpu.models import get_model

    model = get_model(cfg)
    img_w, img_h = cfg.MODEL.IMAGE_SIZE
    x = jnp.zeros((1, img_h, img_w, 6))
    kw = {"lambda_vec": jnp.zeros((1, 2))} if lam else {}
    shapes = jax.eval_shape(lambda k: model.init(k, x, train=False, **kw),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def _port(cfg, variables, lam: bool = False):
    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.models.hrnet import get_pose_net

    model = get_pose_net(cfg, lambda_head=lam).eval()
    model.load_state_dict(from_flax(variables), strict=True)
    return model


def _input(seed=0, n=2):
    return np.random.RandomState(seed).randn(n, 96, 64, 6).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("mode", ["plain", "film", "lambda", "features"])
@pytest.mark.parametrize("opts", [TINY, PLAIN], ids=["prenet", "no_prenet"])
def test_pose_hrnet_matches_jax(opts, mode):
    cfg, tcfg = load_cfg("jax", PRENET_YAML, opts), load_cfg("torch", PRENET_YAML, opts)
    lam = mode == "lambda"
    model, variables = _variables(cfg, seed=1, lam=lam)
    port = _port(tcfg, variables, lam)
    x = _input()
    rng = np.random.RandomState(2)
    kw, tkw = {}, {}
    if mode == "film":
        mu, sigma = rng.randn(2, 8).astype(np.float32), rng.uniform(0.5, 1.5, (2, 8)).astype(np.float32)
        kw["film"] = (jnp.asarray(mu), jnp.asarray(sigma))
        tkw["film"] = (torch.from_numpy(mu), torch.from_numpy(sigma))
    elif mode == "lambda":
        lv = rng.uniform(0, 1, (2, 2)).astype(np.float32)
        kw["lambda_vec"], tkw["lambda_vec"] = jnp.asarray(lv), torch.from_numpy(lv)
    elif mode == "features":
        kw["return_features"] = tkw["return_features"] = True
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False, **kw))
    with torch.inference_mode():
        got = port(_nchw(x), **tkw).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == ((2, 24, 16, 8) if mode == "features" else (2, 24, 16, 14))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_state_dict_round_trips_through_jax_converter():
    """torch_to_flax(port.state_dict(), template, strict=True) rebuilds the JAX
    variables exactly, the preNet stems and the lambda head included."""
    from buctd_tpu.convert import torch_to_flax

    cfg = load_cfg("jax", PRENET_YAML, TINY)
    _, template = _variables(cfg, seed=0, lam=True)
    _, variables = _variables(cfg, seed=3, lam=True)
    port = _port(load_cfg("torch", PRENET_YAML, TINY), variables, lam=True)
    assert any(k.startswith("rgb_preNet.2.") for k in port.state_dict())
    back = torch_to_flax(port.state_dict(), template, strict=True)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_back) == len(flat_want) > 50
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_want[path],
                                      err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def fused_pair():
    from buctd_tpu.models.fuse import maybe_fuse_prenet as jax_fuse

    opts = TINY + ["TPU.FUSED_PRENET", "auto"]
    cfg, tcfg = load_cfg("jax", PRENET_YAML, opts), load_cfg("torch", PRENET_YAML, opts)
    model, variables = _variables(cfg, seed=4)
    fmodel, fvars = jax_fuse(cfg, model, variables)
    return cfg, tcfg, model, variables, fmodel, fvars


def test_fuse_prenet_variables_match_jax(fused_pair):
    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.models.fuse import fuse_prenet_variables

    *_, variables, _, fvars = fused_pair
    got = fuse_prenet_variables(from_flax(variables))
    want = from_flax(fvars)                      # _prenet_fused -> prenet_fused
    assert not any(k.startswith(("rgb_preNet", "cond_preNet")) for k in got)
    assert tuple(got["prenet_fused.b.weight"].shape) == (3, 67, 7, 7)
    assert sorted(got) == sorted(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0, msg=key)


def test_fused_model_matches_jax_and_unfused(fused_pair):
    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.models.fuse import maybe_fuse_prenet

    _, tcfg, model, variables, fmodel, fvars = fused_pair
    port = _port(tcfg, variables)
    fused = maybe_fuse_prenet(tcfg, port)
    assert fused is not port and fused.fused_prenet and not fused.training
    # from_flax carries JAX's fused tree into the port's fused module
    from_jax = maybe_fuse_prenet(tcfg, _port(tcfg, variables))
    from_jax.load_state_dict(from_flax(fvars), strict=True)
    x = _input(seed=5)
    want = np.asarray(fmodel.apply(fvars, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = fused(_nchw(x)).permute(0, 2, 3, 1).numpy()
        got_jax_weights = from_jax(_nchw(x)).permute(0, 2, 3, 1).numpy()
        unfused = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got, got_jax_weights)
    scale = np.abs(unfused).max()
    assert np.abs(got - unfused).max() / scale < 1e-5


def test_maybe_fuse_is_identity_when_off_or_inapplicable(fused_pair):
    from buctd_tpu_torch.models import get_model
    from buctd_tpu_torch.models.fuse import maybe_fuse_prenet

    _, tcfg, _, variables, _, _ = fused_pair
    port = _port(tcfg, variables)
    off = load_cfg("torch", PRENET_YAML, TINY)            # the default: "off"
    assert str(off.TPU.FUSED_PRENET) == "off"
    assert maybe_fuse_prenet(off, port) is port and not port.fused_prenet
    # no preNet in the model: untouched even with the knob on
    on = load_cfg("torch", PRENET_YAML, PLAIN + ["TPU.FUSED_PRENET", "auto"])
    plain = get_model(on, device="cpu")
    assert maybe_fuse_prenet(on, plain) is plain
    coam = get_model(load_cfg("torch", opts=TINY_COAM + ["TPU.FUSED_PRENET", "auto"]),
                     device="cpu")
    assert maybe_fuse_prenet(tcfg, coam) is coam
    # idempotent: fusing a fused model is a no-op
    fused = maybe_fuse_prenet(tcfg, port)
    assert maybe_fuse_prenet(tcfg, fused) is fused
    # eval only
    with pytest.raises(RuntimeError, match="eval-only"):
        fused.train()(_nchw(_input(n=1)))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = load_cfg("jax", PRENET_YAML, TINY)
    _, variables = _variables(cfg, seed=6)
    port = _port(load_cfg("torch", PRENET_YAML, TINY), variables)
    path = tmp_path_factory.mktemp("prenet") / "tiny_prenet.pth"
    torch.save(port.state_dict(), path)
    return str(path)


@pytest.mark.parametrize("knob", ["off", "auto"])
def test_pose_estimator_matches_jax(checkpoint, knob):
    """Both estimators load one .pth and fuse (or not) after the load."""
    from buctd_tpu.serving import PoseEstimator as JaxEstimator
    from buctd_tpu_torch.serving import PoseEstimator
    from test_torch_port_serving import MARGIN, _Recorder

    opts = TINY + ["TPU.FUSED_PRENET", knob]
    jcfg, tcfg = load_cfg("jax", PRENET_YAML, opts), load_cfg("torch", PRENET_YAML, opts)
    rng = np.random.RandomState(7)
    img = rng.randint(0, 256, (200, 300, 3)).astype(np.uint8)
    conds = np.concatenate([rng.uniform(60, 180, (3, 14, 2)),
                            np.ones((3, 14, 1))], -1).astype(np.float32)
    est = PoseEstimator(tcfg, checkpoint=checkpoint, refine_iters=2, device="cpu")
    assert est.model.fused_prenet == (knob == "auto")
    rec = _Recorder(est.model)
    jest = JaxEstimator(jcfg, checkpoint=checkpoint, refine_iters=2)
    assert getattr(jest.model, "fused_prenet", False) == (knob == "auto")
    got, want = est.predict(img, conds, -np.inf), jest.predict(img, conds, -np.inf)
    assert got.shape == (3, 14, 3) and np.isfinite(got).all()
    assert rec.min_margin() > MARGIN, rec.min_margin()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)
