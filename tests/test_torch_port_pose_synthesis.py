"""buctd_tpu_torch's batched condition sampler (data/pose_synthesis_device.py,
TPU.DEVICE_SYNTHESIS) vs buctd_tpu's (data/pose_synthesis_jax.py), on the CPU.

* the spec tables equal JAX's exactly, for coco, crowdpose and a generic
  J = 7;
* the building blocks on the same inputs: ``_annulus`` given JAX's uniform
  draws (4e-5 px, about one f32 ulp at these coordinates: cos/sin in
  another library), ``_over`` (bit for bit:
  squared distances against JAX's norms, on points away from the radius),
  the masked pick, and the special slot for every combination of the
  inversion anchor and the swap-inversion mask, against JAX's expression
  and against the reference's concatenated-index rule;
* the sampler is stochastic, so parity is distributional: on
  tests/test_pose_synthesis.py's COCO scenario the good, jitter, far and
  zero rates agree with JAX's sampler within 0.05 (the tolerance of JAX's
  own device-vs-host test), and the far rate is above 0.01;
* invisible joints seed from the estimate; crowdpose and fish run finite;
* the device loader with TPU.DEVICE_SYNTHESIS: its conditions come from the
  batched sampler (the host sampler is never called), one seed gives one
  batch, the next step other draws, and the conditions differ from GT.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_data_pipeline import _seed_all, _tiny_coco
from test_pose_synthesis import _coco_scenario, _mode_stats
from test_torch_port_config import COAM_YAML, load_cfg

RATE_ATOL = 0.05


def _cfg(dataset, J):
    return types.SimpleNamespace(MODEL=types.SimpleNamespace(NUM_JOINTS=J),
                                 DATASET=types.SimpleNamespace(DATASET=dataset))


@pytest.mark.parametrize("dataset,J", [("coco", 17), ("crowdpose", 14), ("fish", 7)])
def test_make_spec_equals_jax(dataset, J):
    from buctd_tpu.data.pose_synthesis_jax import make_spec as jax_spec
    from buctd_tpu_torch.data.pose_synthesis_device import make_spec

    ours, theirs = make_spec(dataset, J), jax_spec(dataset, J)
    assert ours._fields == theirs._fields
    for name, a, b in zip(ours._fields, ours, theirs):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


def test_annulus_given_jax_draws():
    from buctd_tpu.data.pose_synthesis_jax import _annulus as jax_annulus
    from buctd_tpu_torch.data.pose_synthesis_device import _annulus

    rng = np.random.RandomState(0)
    for k in range(4):
        key = jax.random.PRNGKey(k)
        center = rng.uniform(0, 300, 2).astype(np.float32)
        lo, hi = (0.0, 30.0) if k % 2 else (12.5, 40.0)
        pts, r = jax_annulus(key, jnp.asarray(center), lo, hi, 64)
        ka, kr = jax.random.split(key)                  # _annulus's own draws
        u_a, u_r = jax.random.uniform(ka, (64,)), jax.random.uniform(kr, (64,))
        got, got_r = _annulus(torch.from_numpy(center), lo, hi,
                              torch.from_numpy(np.array(u_a)), torch.from_numpy(np.array(u_r)))
        np.testing.assert_allclose(got_r.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(pts), rtol=0, atol=4e-5)


@pytest.mark.parametrize("per_sample", [False, True], ids=["scalar_r", "per_sample_r"])
def test_over_equals_jax(per_sample):
    from buctd_tpu.data.pose_synthesis_jax import _over as jax_over
    from buctd_tpu_torch.data.pose_synthesis_device import _over

    rng = np.random.RandomState(1)
    B, n, A = 6, 200, 9
    pts = rng.uniform(0, 100, (B, n, 2)).astype(np.float32)
    anchors = rng.uniform(0, 100, (B, A, 2)).astype(np.float32)
    avalid = rng.rand(B, A) > 0.3
    exempt = rng.rand(B, A) > 0.7
    radius = (rng.uniform(5, 30, (B, n)) if per_sample else rng.uniform(5, 30, B)).astype(np.float32)
    got = _over(*(torch.from_numpy(a) for a in (pts, anchors, avalid, exempt, radius)))
    for b in range(B):
        d = np.linalg.norm(pts[b, :, None] - anchors[b, None], axis=-1)
        r = radius[b][:, None] if per_sample else radius[b]
        clear = np.abs(d - r).min(axis=1) > 1e-3            # no sample on the radius
        want = np.asarray(jax_over(jnp.asarray(pts[b]), jnp.asarray(anchors[b]),
                                   jnp.asarray(avalid[b]), jnp.asarray(exempt[b]),
                                   jnp.asarray(radius[b])))
        np.testing.assert_array_equal(got[b].numpy()[clear], want[clear])
        assert clear.mean() > 0.95


def test_masked_pick_equals_jax_and_takes_the_first_row_when_nothing_is_kept():
    from buctd_tpu.data.pose_synthesis_jax import _masked_uniform_pick as jax_pick
    from buctd_tpu_torch.data.pose_synthesis_device import _masked_uniform_pick

    rng = np.random.RandomState(2)
    pts = rng.uniform(0, 50, (5, 40, 2)).astype(np.float32)
    keep = rng.rand(5, 40) > 0.6
    keep[3] = False                                          # nothing kept
    for b in range(5):
        key = jax.random.PRNGKey(b)
        xy, found = jax_pick(key, jnp.asarray(pts[b]), jnp.asarray(keep[b]))
        u = np.array(jax.random.uniform(key, (40,)))
        got, got_found = _masked_uniform_pick(torch.from_numpy(u), torch.from_numpy(pts[b]),
                                              torch.from_numpy(keep[b]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(xy))
        assert bool(got_found) == bool(found) == bool(keep[b].any())
    got, found = _masked_uniform_pick(torch.rand(40), torch.from_numpy(pts[3]),
                                      torch.from_numpy(keep[3]))
    np.testing.assert_array_equal(got.numpy(), pts[3, 0])
    assert not bool(found)


def _reference_special(inv_valid: bool, swap_m, swapinv_m) -> int:
    """The reference's special slot 1 + len(swaps) in its concatenation of the
    valid anchors [gt, swaps, inv, swap_invs], mapped to the fixed layout."""
    P = len(swap_m)
    fixed = ([0] + [1 + p for p in range(P) if swap_m[p]] + ([P + 1] if inv_valid else [])
             + [P + 2 + p for p in range(P) if swapinv_m[p]])
    special = 1 + int(np.sum(swap_m))
    return fixed[special] if special < len(fixed) else 2 * P + 2


def test_special_slot_every_combination():
    from buctd_tpu_torch.data.pose_synthesis_device import special_slot

    P = 3
    A = 2 * P + 2
    combos = [(inv, np.array(m, bool)) for inv in (False, True)
              for m in itertools.product([False, True], repeat=P)]
    inv_valid = torch.tensor([c[0] for c in combos])
    swapinv_m = torch.from_numpy(np.stack([c[1] for c in combos]))
    got = special_slot(inv_valid, swapinv_m).numpy()
    for (inv, m), g in zip(combos, got):
        # buctd_tpu/data/pose_synthesis_jax.py:157-164
        jm = jnp.asarray(m)
        want = int(jnp.where(inv, P + 1, jnp.where(jm.any(), P + 2 + jnp.argmax(jm), A)))
        assert g == want, (inv, m)
        for swap_m in itertools.product([False, True], repeat=P):
            assert g == _reference_special(inv, np.array(swap_m), m), (inv, m, swap_m)


def test_gumbel_is_finite_at_the_ends_of_its_draws():
    from buctd_tpu_torch.data.pose_synthesis_device import _gumbel, _log_weights

    u = torch.tensor([0.0, 1.0 - 2.0 ** -24, 0.5])
    assert torch.isfinite(_gumbel(u)).all()
    w = _log_weights(torch.tensor([0.0, 2.0, 1e-20]), u, 1e-9)
    assert w[0] == -np.inf and torch.isfinite(w[1:]).all()


def _rates(sampler, n, joints, est, near, area):
    from buctd_tpu.data.pose_synthesis import COCO_SIGMAS

    out = sampler(np.repeat(joints[None], n, 0), np.repeat(est[None], n, 0),
                  [near] * n, np.full(n, float(area)))
    return _mode_stats(np.asarray(out), joints, area, COCO_SIGMAS)


def test_batched_sampler_rates_match_jax():
    from buctd_tpu.data.pose_synthesis_jax import make_synthesize_fn as jax_fn
    from buctd_tpu_torch.data.pose_synthesis_device import make_synthesize_fn

    joints, est, near, area = _coco_scenario(np.random.RandomState(7))
    cfg = _cfg("coco", 17)
    n = 150
    fn = make_synthesize_fn(cfg, P_max=4, device="cpu")
    jfn = jax_fn(cfg, P_max=4)
    ours = _rates(lambda *a: fn(torch.Generator().manual_seed(0), *a).numpy(),
                  n, joints, est, near, area)
    theirs = _rates(lambda *a: jfn(jax.random.PRNGKey(0), *a), n, joints, est, near, area)
    np.testing.assert_allclose(ours, theirs, atol=RATE_ATOL)
    assert ours[2] > 0.01                     # the far bucket (miss, swap, inversion) exists
    assert abs(ours.sum() - 1) < 1e-6


def test_invisible_joints_seed_from_the_estimate_and_variants_run():
    from buctd_tpu_torch.data.pose_synthesis_device import make_synthesize_fn

    J = 17
    joints = np.zeros((J, 3))
    joints[:, :2] = 100.0
    joints[:5, 2] = 0
    joints[5:, 2] = 2
    est = joints.copy()
    est[:, :2] = 200.0
    fn = make_synthesize_fn(_cfg("coco", J), P_max=2, device="cpu")
    out = fn(torch.Generator().manual_seed(1), joints[None], est[None],
             [np.zeros((0, J, 3))], np.array([40000.0]))[0].numpy()
    live = out[:5, 2] > 0
    assert live.any()
    assert (np.linalg.norm(out[:5, :2] - 200.0, axis=-1)[live] < 150).all()

    for ds, J2 in [("crowdpose", 14), ("fish", 7)]:
        j2 = np.zeros((J2, 3))
        j2[:, :2] = np.random.RandomState(0).uniform(50, 150, (J2, 2))
        j2[:, 2] = 2
        fn2 = make_synthesize_fn(_cfg(ds, J2), P_max=2, device="cpu")
        o = fn2(torch.Generator().manual_seed(2), j2[None], j2[None], [j2[None]],
                np.array([10000.0]))[0].numpy()
        assert o.shape == (J2, 3) and np.isfinite(o).all()
        assert (np.linalg.norm(o[:, :2] - j2[:, :2], axis=-1) < 500).all()


def test_device_loader_synthesizes_on_its_device(tmp_path, monkeypatch):
    from buctd_tpu_torch.data import joints_dataset
    from buctd_tpu_torch.data.datasets import get_dataset
    from buctd_tpu_torch.data.device_pipeline import DeviceLoader
    from buctd_tpu_torch.data.pipeline import device_synthesize_batch

    def host_sampler(*a, **k):
        raise AssertionError("the host sampler ran under TPU.DEVICE_SYNTHESIS")

    monkeypatch.setattr(joints_dataset, "synthesize_pose", host_sampler)
    ann_file, _ = _tiny_coco(tmp_path, J=14)
    cfg = load_cfg("torch", COAM_YAML, [
        "MODEL.IMAGE_SIZE", "[96, 128]", "MODEL.HEATMAP_SIZE", "[24, 32]",
        "TPU.DEVICE_PIPELINE", "True", "TPU.DEVICE_SYNTHESIS", "True",
        "DATASET.TRAIN_IMAGE_DIR", str(tmp_path), "DATASET.TRAIN_ANNOTATION_FILE", ann_file])
    assert cfg.DATASET.SYNTHESIS_POSE

    def loader(seed):
        out = DeviceLoader(get_dataset(cfg, is_train=True), cfg, batch_size=4,
                           num_workers=1, seed=seed, device="cpu")
        assert out.device_synth is not None
        return out

    def first_batch(seed):
        ld = loader(seed)
        _seed_all(7)                                    # the host's own draws
        batch = next(iter(ld))
        ld.close()
        return batch

    a, b = first_batch(3), first_batch(3)
    for key in ("cond_joints", "joints", "trans_inv"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    torch.testing.assert_close(a["input"], b["input"], rtol=0, atol=0)
    assert np.isfinite(a["cond_joints"]).all()

    # the sampler's poses (image frame) by (loader seed, step)
    idxs = np.arange(4)
    ld3, ld3b, ld4 = loader(3), loader(3), loader(4)
    s0, s1 = (np.stack(device_synthesize_batch(ld3, idxs)) for _ in range(2))
    np.testing.assert_array_equal(s0, np.stack(device_synthesize_batch(ld3b, idxs)))
    for other in (s1, np.stack(device_synthesize_batch(ld4, idxs))):
        assert np.abs(s0[..., :2] - other[..., :2]).max() > 1.0
    gt = np.stack([ld3.ds.db[i]["joints_3d"] for i in idxs])
    moved = np.linalg.norm(s0[..., :2] - gt[..., :2], axis=-1)[s0[..., 2] > 0]
    assert moved.max() > 1.0 and s0.shape == (4, 14, 3)
    for ld in (ld3, ld3b, ld4):
        ld.close()
