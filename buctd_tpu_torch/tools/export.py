"""Export the serving pipeline as a standalone ``torch.export`` artifact.

Counterpart of the repository's tools/export.py: writes the bucketed
crop -> render -> forward -> decode (-> refine) programs and the weights into a
directory that ``buctd_tpu_torch.serving_export.ExportedPoseEstimator`` (or
``python -m buctd_tpu_torch.tools.serve --exported DIR``) serves with no
model or config code and no re-tracing.

    python -m buctd_tpu_torch.tools.export --cfg <yaml> [--checkpoint model.pth]
        --out artifact_dir --shape 512x512x16 --shape 4x512x512x16
        [--refine-iters 3] [--device cuda] [--selftest] [KEY VALUE ...]

Each ``--shape`` is h x w x p (a single-image program) or n x h x w x p (a
batched program); h, w and p snap up to the serving bucket tables
(serving.py).  The programs are traced on ``--device`` (default cuda) in
``TPU.EVAL_DTYPE`` and run only there (serving_export.py's caveat), so the
root tool's ``--platforms`` is ``--device`` here.  ``--selftest``
reloads the artifact and holds its first program against the live
estimator on a random input (within 1e-5, as JAX's tool).
``--checkpoint`` takes a BUCTD ``.pth``/``.pt`` or an orbax directory of JAX's
``save_params`` (convert.py::load_checkpoint).
"""

from __future__ import annotations

import argparse
import time
import types

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="BUCTD serving export (PyTorch/CUDA)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="a BUCTD .pth/.pt or an orbax directory")
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--shape", action="append", required=True,
                   help="HxWxP or NxHxWxP bucket to export (repeatable)")
    p.add_argument("--refine-iters", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda or cpu: where the programs run")
    p.add_argument("--selftest", action="store_true",
                   help="reload the artifact and check it against the live estimator")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def selftest(est, loaded, key) -> float:
    """The largest difference between the artifact's program ``key`` and the
    live estimator on one random request of that bucket."""
    rng = np.random.RandomState(0)
    n, (h, w, p) = (key[0] if len(key) == 4 else 0), key[-3:]
    images = [rng.randint(0, 255, (h, w, 3)).astype(np.uint8) for _ in range(max(n, 1))]
    conds = [rng.uniform(0.2 * w, 0.8 * w, (p, est.num_joints, 2)).astype(np.float32)
             for _ in images]
    keep = float("-inf")   # every joint compared, whatever its confidence
    if n:
        want = est.predict_batch(images, conds, keep)
        got = loaded.predict_batch(images, conds, keep)
    else:
        want = [est.predict(images[0], conds[0], keep)]
        got = [loaded.predict(images[0], conds[0], keep)]
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g, wt, atol=1e-5, rtol=0)
    return max(float(np.abs(g - wt).max()) for g, wt in zip(got, want))


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ..config import default_config, update_config
    from ..serving import PoseEstimator
    from ..serving_export import ExportedPoseEstimator, export_estimator

    cfg = default_config()
    update_config(cfg, types.SimpleNamespace(cfg=args.cfg, opts=args.opts))
    shapes = [tuple(int(v) for v in s.lower().split("x")) for s in args.shape]
    est = PoseEstimator(cfg, checkpoint=args.checkpoint, refine_iters=args.refine_iters,
                        device=args.device)
    t0 = time.perf_counter()
    manifest = export_estimator(est, shapes, args.out)
    print(f"# exported {len(manifest['programs'])} programs ({manifest['model_name']}, "
          f"refine_iters={args.refine_iters}, {manifest['eval_dtype']}, "
          f"{args.device}) in {time.perf_counter() - t0:.1f} s -> {args.out}")
    if args.selftest:
        key = tuple(manifest["programs"][0])
        err = selftest(est, ExportedPoseEstimator(args.out, device=args.device), key)
        print(f"# selftest ok: program {key} within {err:.3e} of the live estimator")
    return manifest


if __name__ == "__main__":
    main()
