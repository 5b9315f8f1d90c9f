"""buctd_tpu_torch's bf16 serving and evaluation (``TPU.EVAL_DTYPE bfloat16``)
vs buctd_tpu's, on the CPU at tiny widths.

JAX builds its model with ``dtype=bfloat16`` (f32 parameters); the port runs
its f32-parameter model under bf16 autocast.  Both carry the same weights
(``convert.from_flax``) and take the same numpy inputs, made from a seed.
The unit of a heatmap gap is one bf16 step of the output, 2^-8 x max |JAX's
heatmaps|; ``PYTHONPATH=.:tests python tests/test_torch_port_eval_bf16.py``
prints every gap the tests hold.

* One refinement round (``core/refine.py::make_refine_fn``) of the tiny
  CoAM, preNet (fused and not) and TransPose-H models: the heatmaps bf16 on
  both sides.  The HRNet models' within the whole-model tolerance that
  tests/test_torch_port_bf16_trunk.py states (MODEL_TOL_STEPS; measured
  5.1 to 5.7 steps): sub-step differences compound through the trunk and
  the attention amplifies them.  TransPose-H's condition reaches its encoder
  through one 1x1 conv, ``trans_cond``, with no norm: at its N(0, 1/fan_in)
  draw the rendered condition's 255 gives tokens near 400 and logits near
  1e4, where one bf16 step of a logit reorders the softmax (JAX's own bf16
  model then lands 93.4 steps from its f32 one).  A trained trans_cond maps
  the 0-255 condition to O(1) tokens, so here it carries 1/255 of its draw
  on both sides; the round's heatmaps are held within TP_TOL_STEPS, twice
  the 22.5 measured.  The round's maxvals come out bf16 on both sides.
* The same round's rounding points: every module that both models name
  returns the same dtype in the port as in JAX's bf16 model (flax's
  ``capture_intermediates``), bf16 for most of them.  A whole-model gap
  cannot tell a bf16 forward from an f32 one at these sizes (JAX's f32
  heatmaps lie 3.5 to 9.5 steps from its bf16 ones, inside every tolerance
  above), so this is the check that does: the port's f32 forward of the same
  input, the control, must differ.
* The validate step with the flip test and the 1-px shift: the averaged
  heatmaps at the same tolerance and bf16; the port's loss and PCK on JAX's
  bf16 heatmaps equal to JAX's (both widen bf16 exactly and sum in f32).
* The decode on hand-built bf16 heatmaps with plateaus and ties: argmax,
  maxvals, the POST_PROCESS nudge and DARK bit for bit to JAX's in the crop
  frame, the image-frame predictions within AFFINE_ATOL px (the f32 inverse
  affine, which XLA contracts into other roundings).  DARK rounds each blur
  tap and every step to bf16 as jnp does; the same decode widened to f32
  first misses (the control).
* The warp and the render on TF32 operands (``ops/tf32.py::tf32_operand``,
  what a bf16 call takes on the card, as XLA's default precision does on a
  GPU): off the exact result, and within three TF32 roundings of it.  An f32
  and a bf16 estimator in one process (CPU): both take the exact warp and
  render there, as XLA does on the CPU, and no call reads or sets the
  process's TF32 flags.
* ``valid.run`` evaluates two rounds in bf16 on the CPU: its confidences are
  bf16 values.  ``check_eval_options`` takes ``EVAL_DTYPE bfloat16``; the
  other refusals stay (the lambda sweep and the debug dumps are ported).
  ``predict_many`` is a loop of ``predict``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_bf16_trunk import MODEL_TOL_STEPS as HRNET_TOL_STEPS
from test_torch_port_config import COAM_YAML, TINY_COAM, jax_variables, load_cfg, port_model
from test_torch_port_prenet import PRENET_YAML
from test_torch_port_prenet import TINY as TINY_PRENET
from test_torch_port_transpose import TINY_TRANSPOSE, TRANSPOSE_YAML

BF16 = ["TPU.EVAL_DTYPE", "bfloat16"]
STEP = 2.0 ** -8
# image-frame predictions: the crop-frame decode is bit for bit, then the
# f32 inverse affine (coords * s + t) lands a few ulps of a ~300 px value
# apart (measured 3.1e-5)
AFFINE_ATOL = 1e-4
# TransPose-H's refine round, trans_cond at 1/255 of its draw: twice the
# 22.5 steps measured (tests/test_torch_port_transpose.py holds the whole
# model on randn inputs within 7.5; the round's crops and condition drive
# its trunk and encoder harder)
TP_TOL_STEPS = 45.0
# the share of JAX's modules whose names the port's model also has (the
# rest: flax's Dropout, the packed in_proj and wrapper levels)
MIN_SHARED_MODULES = 0.8

# name -> (yaml, tiny overrides, joints, fused preNet, heatmap tolerance in steps)
MODELS = {
    "coam": (COAM_YAML, TINY_COAM, 14, False, HRNET_TOL_STEPS[False]),
    "prenet": (PRENET_YAML, TINY_PRENET, 14, False, HRNET_TOL_STEPS[False]),
    "prenet_fused": (PRENET_YAML, TINY_PRENET, 14, True, HRNET_TOL_STEPS[False]),
    "transpose": (TRANSPOSE_YAML, TINY_TRANSPOSE, 17, False, TP_TOL_STEPS),
}


def _steps(got, want) -> float:
    """max |got - want| in bf16 steps of max |want| (both NCHW)."""
    got, want = got.float(), torch.as_tensor(np.asarray(want, np.float32))
    return ((got - want).abs().max() / want.abs().max()).item() / STEP


def _nchw(a):
    """JAX's NHWC output (bf16 or f32) -> f32 NCHW torch."""
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def _unit_scale_condition(variables):
    """``variables`` with TransPose-H's trans_cond kernel at 1/255 (the
    others have none): O(1) condition tokens from the 0-255 render."""
    params = variables["params"]
    if "trans_cond" not in params:
        return variables
    cond = {**params["trans_cond"], "kernel": params["trans_cond"]["kernel"] / 255.0}
    return {**variables, "params": {**params, "trans_cond": cond}}


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(JAX cfg, port cfg, JAX bf16 model, variables, port model) of a tiny
    model in bf16 evaluation, the preNet fused on both sides where asked."""
    from buctd_tpu.models import get_model
    from buctd_tpu.models.fuse import maybe_fuse_prenet as jax_fuse
    from buctd_tpu_torch.models.fuse import maybe_fuse_prenet

    yaml, opts, _, fused, _ = MODELS[name]
    opts = list(opts) + BF16 + ["TPU.FUSED_PRENET", "auto" if fused else "off"]
    jcfg, tcfg = load_cfg("jax", yaml, opts), load_cfg("torch", yaml, opts)
    variables = _unit_scale_condition(jax_variables(jcfg, seed=5)[1])
    port = maybe_fuse_prenet(tcfg, port_model(tcfg, variables))
    jmodel, variables = jax_fuse(jcfg, get_model(jcfg, dtype=jnp.bfloat16), variables)
    return jcfg, tcfg, jmodel, variables, port


def _request(cfg, seed=6, poses=3):
    """A seeded image and condition poses inside it, in the cfg's joints."""
    J = int(cfg.MODEL.NUM_JOINTS)
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (200, 300, 3)).astype(np.uint8)
    conds = np.concatenate([rng.uniform(60, 180, (poses, J, 2)),
                            np.ones((poses, J, 1))], -1).astype(np.float32)
    return img, conds, np.linspace(0, 255, J * 3).reshape(-1, 3)


def _flax_dtypes(tree, path=()) -> dict:
    """name -> output dtype of every module in flax's captured intermediates
    whose output is one array, named as the port names it: the JAX path's
    parts joined by dots, without its wrapper levels (convert.from_flax)."""
    from buctd_tpu_torch.convert import _KEPT

    out = {}
    for key, value in tree.items():
        if key == "__call__":
            if hasattr(value[0], "dtype"):
                parts = [_KEPT.get(p, p) for p in path]
                out[".".join(p for p in parts if not p.startswith("_"))] = value[0].dtype
        else:
            out.update(_flax_dtypes(value, path + (key,)))
    return out


def _port_dtypes(model):
    """(name -> output dtype of every module of ``model`` whose output is a
    tensor, filled as it runs; the hooks' handles)."""
    dtypes = {}

    def record(name):
        def hook(module, args, out):
            if torch.is_tensor(out):
                dtypes[name] = out.dtype
        return hook

    return dtypes, [m.register_forward_hook(record(n)) for n, m in model.named_modules()]


class _Recording:
    """JAX model whose ``apply`` hands each output to the host (the refine
    function is jitted: its heatmaps are not among its results) and keeps
    its modules' output dtypes (known when it traces)."""

    def __init__(self, model):
        self.model, self.maps, self.dtypes = model, [], {}

    def apply(self, variables, x, train=False):
        out, state = self.model.apply(variables, x, train=train, capture_intermediates=True,
                                      mutable=["intermediates"])
        self.dtypes = _flax_dtypes(state["intermediates"])
        jax.debug.callback(lambda o: self.maps.append(np.asarray(o)), out)
        return out


@functools.lru_cache(maxsize=None)
def _refine_round(name, jax_dtype=jnp.bfloat16):
    """One refine round on both sides: (port heatmaps, port maxvals, JAX
    heatmaps (NHWC), JAX maxvals, port module dtypes, JAX module dtypes,
    the port model's input); ``jax_dtype`` f32 runs JAX's f32 model on the
    same variables."""
    from buctd_tpu.core.refine import make_refine_fn as jax_refine_fn
    from buctd_tpu_torch.core.refine import make_refine_fn

    jcfg, tcfg, jmodel, variables, port = _setup(name)
    img, conds, colors = _request(tcfg)
    calls = []
    dtypes, handles = _port_dtypes(port)
    handles.append(port.register_forward_hook(lambda m, args, out: calls.append((args[0], out))))
    try:
        _, m = make_refine_fn(tcfg, port, colors, n_iters=1)(
            torch.from_numpy(img), torch.from_numpy(conds))
    finally:
        for handle in handles:
            handle.remove()
    if jax_dtype != jnp.bfloat16:
        jmodel = jmodel.clone(dtype=jax_dtype)
    rec = _Recording(jmodel)
    _, jm = jax_refine_fn(jcfg, rec, colors, n_iters=1)(
        variables, jnp.asarray(img, jnp.float32), jnp.asarray(conds))
    jax.block_until_ready(jm)
    (x, hm), = calls
    return hm, m, rec.maps[0], jm, dtypes, rec.dtypes, x


@pytest.mark.parametrize("name", list(MODELS))
def test_refine_round_bf16_matches_jax(name):
    hm, m, jhm, jm, *_ = _refine_round(name)
    assert hm.dtype == torch.bfloat16 and jhm.dtype == jnp.bfloat16
    assert m.dtype == torch.bfloat16 and jm.dtype == jnp.bfloat16
    assert _steps(hm, _nchw(jhm)) <= MODELS[name][4]


def _shared_dtypes(port, jax_dtypes) -> dict:
    """name -> (port dtype, JAX dtype as torch's) over the modules both name."""
    return {n: (port[n], getattr(torch, jnp.dtype(d).name))
            for n, d in jax_dtypes.items() if n in port}


@pytest.mark.parametrize("name", list(MODELS))
def test_refine_round_rounds_where_jax_rounds(name):
    _, _, _, _, dtypes, jax_dtypes, x = _refine_round(name)
    shared = _shared_dtypes(dtypes, jax_dtypes)
    missing = sorted(set(jax_dtypes) - set(shared))
    assert len(shared) >= MIN_SHARED_MODULES * len(jax_dtypes), missing
    assert {n: p for n, (p, j) in shared.items() if p != j} == {}
    assert sum(p == torch.bfloat16 for p, _ in shared.values()) > len(shared) / 2
    # the control: the port's f32 forward of the same input
    port = _setup(name)[4]
    f32, handles = _port_dtypes(port)
    try:
        with torch.inference_mode():
            port(x)
    finally:
        for handle in handles:
            handle.remove()
    assert any(p != j for p, j in _shared_dtypes(f32, jax_dtypes).values())


# ------------------------------------------------------------ validate ----
def _validate_step():
    """The flip-test validate step (colored condition, SHIFT_HEATMAP) of the
    tiny CoAM in bf16 on both sides: (port outputs, JAX outputs, batch)."""
    from buctd_tpu.core.function import _make_validate_step
    from buctd_tpu.data.datasets.crowdpose import CrowdPoseDataset as JaxCrowdPose
    from buctd_tpu.data.joints_dataset import rainbow_colors
    from buctd_tpu_torch.core.function import make_validate_step

    jcfg, tcfg, jmodel, variables, port = _setup("coam")
    for cfg in (jcfg, tcfg):
        assert cfg.TEST.FLIP_TEST and cfg.TEST.SHIFT_HEATMAP
    J = 14
    rng = np.random.RandomState(3)
    B, (w_img, h_img), (w_hm, h_hm) = 2, tcfg.MODEL.IMAGE_SIZE, tcfg.MODEL.HEATMAP_SIZE
    batch = {"input": rng.randn(B, h_img, w_img, 6).astype(np.float32),
             "cond_joints": np.concatenate([rng.uniform(2, [w_img - 2, h_img - 2], (B, J, 2)),
                                            np.zeros((B, J, 1))], -1).astype(np.float32),
             "cond_joints_vis": np.repeat((rng.rand(B, J, 1) > 0.25).astype(np.float32), 3, -1),
             "target": (rng.rand(B, h_hm, w_hm, J) > 0.99).astype(np.float32),
             "target_weight": (rng.rand(B, J) > 0.2).astype(np.float32),
             "center": rng.uniform(80, 200, (B, 2)).astype(np.float32),
             "scale": rng.uniform(0.5, 1.2, (B, 2)).astype(np.float32)}
    flip_pairs, colors = JaxCrowdPose.flip_pairs, rainbow_colors(J)
    want = _make_validate_step(jcfg, jmodel, flip_pairs, colors)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["input"] = tb["input"].permute(0, 3, 1, 2).contiguous()
    tb["target"] = tb["target"].permute(0, 3, 1, 2).contiguous()
    for k in ("cond_joints", "cond_joints_vis", "center", "scale"):
        tb[k] = batch[k]                                   # numpy meta, as the loader's
    got = make_validate_step(tcfg, port, flip_pairs, colors)(tb)
    return got, want, tb


def test_validate_step_bf16_matches_jax():
    from buctd_tpu_torch.core.loss import make_loss
    from buctd_tpu_torch.core.metrics import pck_accuracy

    (p, m, loss, acc, cnt, hm), (jp, jm, jloss, jacc, jcnt, jhm), tb = _validate_step()
    assert hm.dtype == torch.bfloat16 and jhm.dtype == jnp.bfloat16
    assert m.dtype == torch.bfloat16 and jm.dtype == jnp.bfloat16
    assert _steps(hm, _nchw(jhm)) <= HRNET_TOL_STEPS[False]
    # the port's loss and PCK on JAX's bf16 heatmaps: JAX's
    jout = _nchw(jhm).to(torch.bfloat16)
    _, tcfg, *_ = _setup("coam")
    jl = make_loss(tcfg)(jout, tb["target"], tb["target_weight"])
    # a mean of ~10^4 f32 squares summed in another order (measured 6e-6)
    np.testing.assert_allclose(float(jl), float(jloss), rtol=1e-5)
    a, c, _ = pck_accuracy(jout, tb["target"])
    assert float(a) == float(jacc) and int(c) == int(jcnt)


# -------------------------------------------------------------- decode ----
def _decode_maps(seed=0, B=3, J=14, h=32, w=24):
    """bf16 heatmaps with peaks, plateaus (quantized maps), exact ties
    (copied peaks) and flat zero maps, as f32 numpy holding bf16 values."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    hm = np.zeros((B, J, h, w), np.float32)
    for b in range(B):
        for j in range(J):
            cy, cx = rng.uniform(1, h - 2), rng.uniform(1, w - 2)
            sig = rng.uniform(1.0, 3.0)
            hm[b, j] = rng.uniform(0.2, 1.5) * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2)
                                                       / (2 * sig ** 2))
    hm += 0.01 * rng.randn(*hm.shape).astype(np.float32)
    hm[:, 0::3] = np.round(hm[:, 0::3] * 8) / 8                  # plateaus
    hm[:, 1, 5, 7] = hm[:, 1, 9, 3] = hm[:, 1].max((1, 2))      # ties at the max
    hm[:, 2] = 0.0                                               # max <= 0
    return np.array(jnp.asarray(hm).astype(jnp.bfloat16).astype(jnp.float32))


def _decode_pair(kw):
    """JAX's and the port's decode of the same bf16 maps: crop-frame
    coords, maxvals, image-frame preds; and the port's on the maps widened
    to f32 first (the control)."""
    import buctd_tpu.ops.decode as jd
    import buctd_tpu_torch.ops.decode as td

    hm = _decode_maps()
    B, _, h, w = hm.shape
    rng = np.random.RandomState(1)
    center = rng.uniform(100, 300, (B, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (B, 2)).astype(np.float32)
    jhm = jnp.asarray(hm).astype(jnp.bfloat16)
    thm = torch.from_numpy(hm).to(torch.bfloat16)

    def crop(mod, maps):
        coords, maxvals = mod.get_max_preds(maps)
        if kw.get("use_dark"):
            coords = mod.dark_refine(maps, coords)
        elif kw.get("post_process"):
            coords = mod.post_process_nudge(maps, coords)
        return coords, maxvals

    jc, jmax = jax.jit(functools.partial(crop, jd))(jhm)
    jp, jm = jd.get_final_preds(jhm, jnp.asarray(center), jnp.asarray(scale), (w, h), **kw)
    tc, tmax = crop(td, thm)
    tp, tm = td.get_final_preds(thm, torch.from_numpy(center), torch.from_numpy(scale),
                                (w, h), **kw)
    control, _ = crop(td, thm.float())
    return ((np.asarray(jc), np.asarray(jmax), np.asarray(jp), np.asarray(jm)),
            (tc, tmax, tp, tm), control)


DECODES = {"argmax": {"post_process": False}, "post_process": {"post_process": True},
           "dark": {"post_process": True, "use_dark": True}}


@pytest.mark.parametrize("kind", list(DECODES))
def test_decode_on_bf16_ties_is_jax_bit_for_bit(kind):
    (jc, jmax, jp, jm), (tc, tmax, tp, tm), control = _decode_pair(DECODES[kind])
    assert tmax.dtype == tm.dtype == torch.bfloat16 and jm.dtype == jnp.bfloat16
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tmax.float().numpy(), np.asarray(jmax, np.float32))
    np.testing.assert_array_equal(tm.float().numpy(), np.asarray(jm, np.float32))
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=AFFINE_ATOL)
    if kind == "dark":   # DARK widened to f32 before the blur: not JAX's answer
        assert not np.array_equal(control.numpy(), jc)
    else:                # argmax and nudge are exact either way
        np.testing.assert_array_equal(control.numpy(), jc)


# ------------------------------------------------------------- serving ----
def _flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def _tf32_cases():
    """name -> fn(tf32) for the aligned warp and the colored and plain
    renders of the bf16 refine round, on seeded inputs."""
    from buctd_tpu_torch.ops.heatmap import render_condition_colored, render_condition_plain
    from buctd_tpu_torch.ops.warp import warp_affine_aligned

    rng = np.random.RandomState(7)
    images = torch.from_numpy(rng.randint(0, 256, (2, 200, 300, 3)).astype(np.float32))
    t = torch.tensor([[[0.93, 0.0, 11.3], [0.0, 0.93, 7.7]],
                      [[1.71, 0.0, -4.2], [0.0, 1.71, 3.1]]] * 2)
    joints = torch.from_numpy(rng.uniform(2, 90, (4, 14, 2)).astype(np.float32))
    colors = rng.uniform(0, 255, (14, 3)).astype(np.float32)
    return {"warp": lambda tf32: warp_affine_aligned(images, t, (128, 96), tf32=tf32),
            "colored": lambda tf32: render_condition_colored(joints, colors, (128, 96), tf32),
            "plain": lambda tf32: render_condition_plain(joints, (128, 96), tf32)}


@pytest.mark.parametrize("case", ["warp", "colored", "plain"])
def test_tf32_operands_round_the_products(case):
    """TF32 operands move the exact result, by at most three TF32 roundings
    (2^-10 relative each: two operands and the warp's intermediate) of the
    peak; the plain render truncates to integers, so there by at most 1.
    Neither reads nor sets the process's TF32 flags."""
    before = _flags()
    fn = _tf32_cases()[case]
    exact, tf32 = fn(False), fn(True)
    assert _flags() == before
    gap = (tf32 - exact).abs().max().item()
    if case == "plain":
        assert gap <= 1.0
    else:
        assert 0.0 < gap <= 3 * 2.0 ** -10 * exact.abs().max().item()


def test_estimators_scope_their_own_precision(monkeypatch):
    """An f32 and a bf16 PoseEstimator in one process (CPU): both take the
    exact warp and render there (XLA's default precision is exact f32 on the
    CPU; the card's bf16 call takes TF32 operands, tests/test_torch_port_cuda.py),
    and the process's flags read before, during (in the warp) and after
    each call are the ones it started with."""
    from buctd_tpu_torch.core import refine
    from buctd_tpu_torch.serving import PoseEstimator

    seen = []
    real_warp, real_render = refine.warp_affine_aligned, refine.render_condition

    def warp(*args, tf32, **kw):
        seen.append(("warp", tf32, _flags()))
        return real_warp(*args, tf32=tf32, **kw)

    def render(*args, tf32, **kw):
        seen.append(("render", tf32, _flags()))
        return real_render(*args, tf32=tf32, **kw)

    monkeypatch.setattr(refine, "warp_affine_aligned", warp)
    monkeypatch.setattr(refine, "render_condition", render)
    _, tcfg, *_ = _setup("coam")
    f32_cfg = load_cfg("torch", COAM_YAML, TINY_COAM)
    img, conds, _ = _request(tcfg, poses=2)
    before = _flags()
    ests = {"f32": PoseEstimator(f32_cfg, device="cpu"),
            "bf16": PoseEstimator(tcfg, device="cpu")}
    assert _flags() == before                 # the constructors set nothing on the CPU
    for name in ("bf16", "f32", "bf16"):
        seen.clear()
        out = ests[name].predict(img, conds, float("-inf"))   # keep every joint
        assert out.dtype == np.float32 and np.isfinite(out).all()
        assert seen == [("warp", False, before), ("render", False, before)]
        assert _flags() == before


def test_predict_many_is_a_loop_of_predict():
    from buctd_tpu_torch.serving import PoseEstimator

    _, tcfg, _, _, port = _setup("coam")
    est = PoseEstimator(tcfg, device="cpu")
    est.model.load_state_dict(port.state_dict())
    reqs = [_request(tcfg, seed=s, poses=p)[:2] for s, p in ((7, 1), (8, 3))]
    many = est.predict_many([r[0] for r in reqs], [r[1] for r in reqs], vis_thres=0.2)
    assert len(many) == 2
    for got, (img, conds) in zip(many, reqs):
        np.testing.assert_array_equal(got, est.predict(img, conds, vis_thres=0.2))


def test_valid_run_evaluates_in_bf16(tmp_path):
    """valid.run.main on the CPU with TEST.REFINE_ITERS 2 in bf16: both
    rounds' results, confidences that are bf16 values widened to f32, and
    round 1 reading round 0's keypoints."""
    import json

    from test_data_pipeline import _tiny_coco
    from test_torch_port_eval import _crowdpose_eval_opts

    from buctd_tpu_torch.valid import run

    ann_file, _ = _tiny_coco(tmp_path, n_imgs=2, people=2, J=14)
    res = run.main(["--cfg", str(COAM_YAML), "--device", "cpu",
                    *_crowdpose_eval_opts(tmp_path, ann_file), *BF16,
                    "TEST.REFINE_ITERS", "2", "OUTPUT_DIR", str(tmp_path / "out")])
    assert len(res["ap"]) == 2 and all(0.0 <= ap <= 1.0 for ap in res["ap"])
    rows = [json.loads((res["output_dir"] / "results" /
                        f"keypoints_test_results_epoch{it}.json").read_text()) for it in range(2)]
    assert len(rows[0]) == len(rows[1]) == 4
    conf = np.array([r["keypoints"][2::3] for r in rows[0]], np.float32)
    assert np.array_equal(torch.from_numpy(conf).to(torch.bfloat16).float().numpy(), conf)
    assert any(a["center"] != b["center"] for a, b in zip(*rows))


def test_check_eval_options_takes_bf16():
    from buctd_tpu_torch.core.function import check_eval_options

    check_eval_options(load_cfg("torch", COAM_YAML, BF16 + ["TPU.DEVICE_PIPELINE", "True"]))
    # the lambda sweep and the debug dumps are ported
    check_eval_options(load_cfg("torch", COAM_YAML, BF16 + [
        "TPU.DEVICE_PIPELINE", "True", "TEST.LAMBDA_SWEEP", "True", "DEBUG.DEBUG", "True"]))
    # the host cv2 Loader (the JAX default) is ported
    check_eval_options(load_cfg("torch", COAM_YAML, BF16 + ["TPU.DEVICE_PIPELINE", "False"]))
    for bad in (["TPU.MESH_SHAPE", "[2]"], ["TPU.MESH_SHAPE", "[4]"]):
        opts = BF16 + ["TPU.DEVICE_PIPELINE", "True"] + bad
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            check_eval_options(load_cfg("torch", COAM_YAML, opts))


def main():
    """Print every gap the tests hold."""
    for name in MODELS:
        hm, _, jhm, _, *_ = _refine_round(name)
        j32 = _refine_round(name, jnp.float32)[2]
        print(f"refine round {name}: heatmaps {_steps(hm, _nchw(jhm)):.3f} steps "
              f"(limit {MODELS[name][4]}); JAX's f32 from its bf16 "
              f"{_steps(_nchw(j32), _nchw(jhm)):.3f}")
    (_, _, _, _, _, hm), (_, _, jloss, jacc, _, jhm), _ = _validate_step()
    print(f"validate step (flip, shift): heatmaps {_steps(hm, _nchw(jhm)):.3f} steps")
    for kind, kw in DECODES.items():
        (jc, _, jp, _), (tc, _, tp, _), control = _decode_pair(kw)
        print(f"decode {kind}: crop coords apart {(tc.numpy() != jc).mean():.4f}, image "
              f"preds max |diff| {np.abs(tp.numpy() - jp).max():.3e} px; f32 control "
              f"apart {(control.numpy() != jc).mean():.4f}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
