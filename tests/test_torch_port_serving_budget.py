"""buctd_tpu_torch PoseEstimator's compile bound (``max_compiles``,
``precompile``) vs buctd_tpu's, on the CPU (tiny CoAM, one round).

The port's estimator and JAX's make the same calls, mirroring
tests/test_serving.py's budget tests (:32, :93, :141, :197): after each call
both have admitted the same bucket shapes, both raise where no admitted
bucket contains a call, a remainder chunk rides the same admitted count
bucket, a batch the budget blocks goes image by image on both, and both
precompile forms admit the same keys, which the calls then reuse (the
3-tuple form in the first test, the 4-tuple form in the second, which also
covers :197).  ``_pick_bucket`` picks the same
containing bucket, the cheapest by h * w * p.  On the CPU the port runs
``refine`` eagerly (an admitted bucket is a CUDA graph only on the card).

Outputs agree to 1e-3 px and 1e-3 in confidence, as in
test_torch_port_serving.py, whose margin check (MARGIN on every heatmap
the port produced) makes that tolerance hold: the same weights cross over
with ``convert.from_flax``.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_port_config import TINY_COAM, jax_variables, load_cfg
from test_torch_port_serving import MARGIN, _Recorder

ATOL, RTOL = 1e-3, 1e-4
J = 14


class _SeededModel:
    """The JAX model with ``init`` returning the seeded variables.  JAX's
    estimator builds its template with a jitted ``model.init`` (18 s at
    this size on one core), and the tests give it these variables anyway."""

    def __init__(self, model, variables):
        self._model, self._variables = model, variables

    def init(self, *args, **kwargs):
        return self._variables

    def __getattr__(self, name):
        return getattr(self._model, name)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = load_cfg("jax", opts=TINY_COAM), load_cfg("torch", opts=TINY_COAM)
    model, variables = jax_variables(jcfg, seed=5)
    colors = np.linspace(0, 255, J * 3).reshape(-1, 3)
    return jcfg, tcfg, model, variables, colors, {}


def estimators(monkeypatch, weights, **kw):
    """(port, JAX) estimators of the same weights, one round, with ``kw``
    (max_compiles, precompile); the port's heatmaps are recorded.  The JAX
    estimators of the module share one jitted ``refine`` (the same config,
    model and colours), so a single-image bucket compiles once for the
    module; each JAX estimator keeps its own bookkeeping."""
    import buctd_tpu.models
    import buctd_tpu.serving
    from buctd_tpu.serving import PoseEstimator as JaxEstimator
    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.serving import PoseEstimator

    jcfg, tcfg, model, variables, colors, shared = weights
    monkeypatch.setattr(buctd_tpu.models, "get_model",
                        lambda cfg, **_: _SeededModel(model, variables))
    make = buctd_tpu.serving.make_refine_fn

    def make_shared(*args, **kwargs):
        if "refine" not in shared:
            shared["refine"] = make(*args, **kwargs)
        return shared["refine"]

    monkeypatch.setattr(buctd_tpu.serving, "make_refine_fn", make_shared)
    jest = JaxEstimator(jcfg, refine_iters=1, colors=colors, **kw)
    jest.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    est = PoseEstimator(tcfg, refine_iters=1, colors=colors, device="cpu", **kw)
    est.model.load_state_dict(from_flax(variables), strict=True)
    est.recorder = _Recorder(est.model)
    return est, jest


def agree(got, want, est):
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
    assert est.recorder.min_margin() > MARGIN


def test_compile_budget_matches_jax(monkeypatch, weights):
    """tests/test_serving.py:32: a precompiled (h, w, p) bucket, one more
    admitted, then a call padded up into the admitted bucket, then a raise."""
    est, jest = estimators(monkeypatch, weights, max_compiles=2, precompile=[(256, 256, 4)])
    assert est._compiled == jest._compiled == {(256, 256, 4)}
    rng = np.random.RandomState(0)
    small = rng.randint(0, 255, (100, 120, 3)).astype(np.uint8)
    big = rng.randint(0, 255, (300, 400, 3)).astype(np.uint8)
    conds = rng.uniform(20, 90, (16, J, 2)).astype(np.float32)
    vis = -np.inf   # random weights: keep every joint
    for image, poses, admitted in ((small, conds[:3], 1), (big, conds[:3], 2),
                                   (small, conds[:2], 2)):
        agree(est.predict(image, poses, vis), jest.predict(image, poses, vis), est)
        assert est._compiled == jest._compiled and len(est._compiled) == admitted
    assert (384, 512, 4) in est._compiled
    for e in (est, jest):
        with pytest.raises(RuntimeError, match="max_compiles"):
            e.predict(small, conds, vis)
    assert est._compiled == jest._compiled


def test_remainder_rides_the_admitted_count_bucket(monkeypatch, weights):
    """tests/test_serving.py:93: a precompiled (4, h, w, p) bucket takes a
    3-image chunk and then a 2-image one, padded with rows."""
    est, jest = estimators(monkeypatch, weights, precompile=[(4, 256, 256, 4)])
    assert est._compiled == jest._compiled == {(4, 256, 256, 4)}
    rng = np.random.RandomState(6)
    imgs = [rng.randint(0, 255, (180, 240, 3)).astype(np.uint8) for _ in range(3)]
    conds = [rng.uniform(30, 150, (3, J, 2)).astype(np.float32) for _ in range(3)]
    for n in (3, 2):
        agree(est.predict_batch(imgs[:n], conds[:n], -np.inf),
              jest.predict_batch(imgs[:n], conds[:n], -np.inf), est)
        assert est._compiled == jest._compiled == {(4, 256, 256, 4)}


def test_spent_budget_falls_back_image_by_image(monkeypatch, weights):
    """tests/test_serving.py:141: with the one-bucket budget spent by a
    predict, a batch goes through the per-image path on both (3 poses: the
    bucket the module has compiled already)."""
    est, jest = estimators(monkeypatch, weights, max_compiles=1)
    rng = np.random.RandomState(4)
    imgs = [rng.randint(0, 255, (120, 140, 3)).astype(np.uint8) for _ in range(2)]
    conds = [rng.uniform(20, 100, (3, J, 2)).astype(np.float32) for _ in range(2)]
    agree(est.predict(imgs[0], conds[0], -np.inf), jest.predict(imgs[0], conds[0], -np.inf),
          est)
    agree(est.predict_batch(imgs, conds, -np.inf), jest.predict_batch(imgs, conds, -np.inf),
          est)
    assert est._compiled == jest._compiled == {(256, 256, 4)}


@pytest.mark.parametrize("admitted,call", [
    ({(256, 2048, 64), (384, 384, 4)}, (256, 256, 2)),   # the cheaper, not the first
    ({(512, 512, 8), (256, 1024, 16)}, (256, 384, 4)),
    ({(256, 256, 4), (4, 256, 256, 4)}, (256, 256, 2)),  # batched keys never picked
    ({(256, 256, 2), (384, 384, 1)}, (256, 256, 4)),     # none contains: raises
])
def test_pick_bucket_matches_jax(admitted, call):
    """With the budget spent, both pick the same admitted bucket for a call
    (bookkeeping only: no program runs)."""
    from buctd_tpu.serving import PoseEstimator as JaxEstimator
    from buctd_tpu_torch.serving import PoseEstimator

    picks = []
    for cls in (PoseEstimator, JaxEstimator):
        e = object.__new__(cls)
        e._compiled, e.max_compiles = set(admitted), len(admitted)
        try:
            picks.append(e._pick_bucket(*call))
        except RuntimeError as err:
            picks.append(type(err))
    assert picks[0] == picks[1]
