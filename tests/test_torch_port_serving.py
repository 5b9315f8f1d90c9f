"""buctd_tpu_torch refinement and PoseEstimator vs buctd_tpu (CPU, tiny CoAM).

Both packages carry the same weights (N(0, 1/fan_in), see
test_torch_port_config.jax_variables), so the heatmaps are peaked.  A decode
is an argmax followed by the sign of a neighbour difference.  The heatmaps
agree to 1e-4 absolute (test_torch_port_models), so a difference of two values
moves by at most 2e-4: each test asserts that the top-two gap and those
neighbour differences clear 5e-4 on every heatmap the port produced.  Then predictions agree to 1e-3 px in image
coordinates and confidences to 1e-3 (f32 crops and forwards in another
summation order, carried through up to three rounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_config import TINY_COAM, jax_variables, load_cfg, port_model

MARGIN = 5e-4


class _Recorder:
    """Forward hook keeping every heatmap batch the port model produced."""

    def __init__(self, model):
        self.maps = []
        model.register_forward_hook(lambda m, i, o: self.maps.append(o.detach().clone()))

    def min_margin(self) -> float:
        """Smallest top-two gap and |neighbour difference| at the argmax over
        all recorded heatmaps: what a decode's argmax and nudge depend on."""
        hm = torch.cat(self.maps).flatten(0, 1)                # (n, h, w)
        n, h, w = hm.shape
        top2 = hm.flatten(1).topk(2, dim=1).values
        gap = (top2[:, 0] - top2[:, 1]).min().item()
        idx = hm.flatten(1).argmax(dim=1)
        py, px = idx // w, idx % w
        inb = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
        r = torch.arange(n)
        dx = (hm[r, py, (px + 1).clamp(max=w - 1)] - hm[r, py, (px - 1).clamp(min=0)]).abs()
        dy = (hm[r, (py + 1).clamp(max=h - 1), px] - hm[r, (py - 1).clamp(min=0), px]).abs()
        return min(gap, dx[inb].min().item(), dy[inb].min().item())


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = load_cfg("jax", opts=TINY_COAM), load_cfg("torch", opts=TINY_COAM)
    model, variables = jax_variables(jcfg, seed=5)
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (200, 300, 3)).astype(np.uint8)
    conds = np.concatenate([rng.uniform(60, 180, (3, 14, 2)),
                            np.ones((3, 14, 1))], -1).astype(np.float32)
    colors = np.linspace(0, 255, 14 * 3).reshape(-1, 3)
    return jcfg, tcfg, model, variables, img, conds, colors


@pytest.mark.parametrize("rounds", [1, 3])
def test_refine_matches_jax(setup, rounds):
    from buctd_tpu.core.refine import make_refine_fn as jax_refine_fn
    from buctd_tpu_torch.core.refine import make_refine_fn

    jcfg, tcfg, model, variables, img, conds, colors = setup
    port = port_model(tcfg, variables)
    rec = _Recorder(port)
    p, m = make_refine_fn(tcfg, port, colors, n_iters=rounds)(
        torch.from_numpy(img), torch.from_numpy(conds))
    pw, mw = jax_refine_fn(jcfg, model, colors, n_iters=rounds)(
        variables, jnp.asarray(img, jnp.float32), jnp.asarray(conds))
    assert len(rec.maps) == rounds
    assert rec.min_margin() > MARGIN
    assert p.shape == (3, 14, 2) and m.shape == (3, 14, 1)
    np.testing.assert_allclose(p.numpy(), np.asarray(pw), atol=1e-3, rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(mw), atol=1e-3, rtol=1e-4)


def test_pose_estimator_matches_jax(setup):
    from buctd_tpu.serving import PoseEstimator as JaxEstimator
    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.serving import PoseEstimator

    jcfg, tcfg, model, variables, img, conds, colors = setup
    est = PoseEstimator(tcfg, refine_iters=2, colors=colors, device="cpu")
    est.model.load_state_dict(from_flax(variables), strict=True)
    rec = _Recorder(est.model)
    jest = JaxEstimator(jcfg, refine_iters=2, colors=colors)
    jest.variables = jax.tree_util.tree_map(jnp.asarray, variables)

    # predict: 3 poses pad to the 4-pose bucket, the image to 256 x 384;
    # random weights give negative confidences, so keep every joint
    vis = -np.inf
    got, want = est.predict(img, conds, vis), jest.predict(img, conds, vis)
    assert got.shape == (3, 14, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)

    # predict_batch: two images of one bucket run as one N*P batch, a third
    # image of another bucket alone
    images = [img, np.ascontiguousarray(img[::-1, :290][:180]), img[:120, :200]]
    poses = [conds, conds * 0.9, conds[1:] * 0.7]
    got_b = est.predict_batch(images, poses, vis)
    want_b = jest.predict_batch(images, poses, vis)
    assert [g.shape for g in got_b] == [(3, 14, 3), (3, 14, 3), (2, 14, 3)]
    for g, w in zip(got_b, want_b):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-4)
    assert rec.min_margin() > MARGIN, rec.min_margin()


def test_pose_estimator_refuses_cpu_fallback(monkeypatch):
    """The default device is CUDA; where CUDA is absent the estimator raises
    instead of running on the CPU silently."""
    from buctd_tpu_torch.serving import PoseEstimator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PoseEstimator(load_cfg("torch", opts=TINY_COAM))
