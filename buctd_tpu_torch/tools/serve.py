"""Batch serving CLI over ``buctd_tpu_torch.serving.PoseEstimator``.

Counterpart of the repository's tools/serve.py: reads a JSON manifest of
images and condition poses, runs the conditional top-down model (with
in-process refinement), and writes the predictions as JSON.  Same-bucket
images run as one batch (``predict_batch``); the compile budget bounds the
bucket shapes, each one CUDA graph on the card (serving.py).

Manifest (a list of entries):
    [{"image": "path/to/img.jpg",
      "poses": [[[x, y, score], ... J entries], ...P poses]}, ...]
``poses`` may have 2 columns (score 1).  The output mirrors the manifest with
a "predictions" field per entry ((P, J, 3) [x, y, conf] lists; entries below
--vis-thres are null).

    python -m buctd_tpu_torch.tools.serve --cfg <yaml> [--checkpoint model.pth]
        --manifest requests.json --out results.json [--refine-iters 3]
        [--vis-thres 0.3] [--max-compiles 12] [--precompile 512,512,8 ...]
        [--device cuda] [KEY VALUE ...]
    python -m buctd_tpu_torch.tools.serve --exported artifact_dir
        --manifest requests.json --out results.json [--device cuda]

``--exported`` serves a ``tools.export`` artifact (no model code); the live
estimator's flags are refused beside it, since the artifact fixes them.
``--data-parallel`` serves over every local card (JAX tools/serve.py:50,
:83-94): ``parallel/mesh.py::make_mesh()`` and ``PoseEstimator(mesh=)``,
one replica a card; with ``--device cpu`` over the CPU alone.
``--checkpoint`` takes a BUCTD ``.pth``/``.pt`` or an orbax directory of JAX's
``save_params`` (convert.py::load_checkpoint).
"""

from __future__ import annotations

import argparse
import json
import time
import types

import numpy as np

_LIVE_DEFAULTS = {"cfg": None, "checkpoint": None, "refine_iters": 1, "max_compiles": 12,
                  "precompile": [], "opts": [], "data_parallel": False}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="BUCTD batch serving (PyTorch/CUDA)")
    p.add_argument("--cfg", default=None)
    p.add_argument("--exported", default=None,
                   help="serve a tools.export artifact directory instead of "
                        "--cfg/--checkpoint (no model code, no re-tracing)")
    p.add_argument("--checkpoint", default=None,
                   help="a BUCTD .pth/.pt or an orbax directory")
    p.add_argument("--manifest", required=True, help="JSON list of {image, poses} entries")
    p.add_argument("--out", required=True, help="output JSON path")
    p.add_argument("--refine-iters", type=int, default=1)
    p.add_argument("--vis-thres", type=float, default=0.0)
    p.add_argument("--max-compiles", type=int, default=12)
    p.add_argument("--precompile", action="append", default=[],
                   help="h,w,p (or n,h,w,p batched) bucket to warm at start-up (repeatable)")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard each batch's images over every local card "
                        "(a live estimator only)")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def build_estimator(args):
    """The estimator ``args`` ask for: an ExportedPoseEstimator or a live
    PoseEstimator; raises SystemExit on what is refused."""
    if args.exported:
        live = sorted(k for k, v in _LIVE_DEFAULTS.items() if getattr(args, k) != v)
        if live:
            raise SystemExit(f"--exported serves the artifact's own model, rounds and "
                             f"buckets; {', '.join('--' + k.replace('_', '-') for k in live)} "
                             f"apply to a live estimator only")
        from ..serving_export import ExportedPoseEstimator
        est = ExportedPoseEstimator(args.exported, device=args.device)
        print(f"# serving from exported artifact {args.exported} "
              f"({est.manifest['model_name']}, {len(est.manifest['programs'])} programs)")
        return est
    if not args.cfg:
        raise SystemExit("one of --cfg or --exported is required")
    from ..config import default_config, update_config
    from ..serving import PoseEstimator

    cfg = default_config()
    update_config(cfg, types.SimpleNamespace(cfg=args.cfg, opts=args.opts))
    precompile = [tuple(int(v) for v in s.split(",")) for s in args.precompile]
    mesh = None
    if args.data_parallel:
        import torch

        from ..parallel.mesh import make_mesh

        devices = None if torch.device(args.device).type == "cuda" else [args.device]
        mesh = make_mesh(devices=devices)
        print(f"# data-parallel over {mesh.size} device(s): {[str(d) for d in mesh.devices]}")
    return PoseEstimator(cfg, checkpoint=args.checkpoint, refine_iters=args.refine_iters,
                         max_compiles=args.max_compiles, precompile=precompile,
                         device=args.device, mesh=mesh)


def main(argv=None) -> list:
    args = parse_args(argv)
    with open(args.manifest) as f:
        entries = json.load(f)
    est = build_estimator(args)

    import cv2
    images, conditions, keep = [], [], []
    for i, e in enumerate(entries):
        img = cv2.imread(e["image"], cv2.IMREAD_COLOR)
        if img is None:
            print(f"# skipping unreadable image: {e['image']}")
            continue
        images.append(img[:, :, ::-1])   # BGR -> RGB
        conditions.append(np.asarray(e["poses"], np.float32))
        keep.append(i)

    t0 = time.perf_counter()
    preds = est.predict_batch(images, conditions, vis_thres=args.vis_thres)
    dt = time.perf_counter() - t0
    n_poses = sum(len(c) for c in conditions)
    print(f"# served {len(images)} images / {n_poses} poses in {dt:.2f}s "
          f"({n_poses / max(dt, 1e-9):.1f} poses/s)")
    for i, p in zip(keep, preds):
        # float64 leaves: json writes them; None where below --vis-thres
        p = np.asarray(p, np.float64)
        entries[i]["predictions"] = np.where(np.isfinite(p), p, None).tolist()
    with open(args.out, "w") as f:
        json.dump(entries, f)
    print(f"# wrote {args.out}")
    return entries


if __name__ == "__main__":
    main()
